"""Tiny cells for the CPU tests: a copy of the benchmark with one more
configuration, traffic mix and cell, at sizes a test run holds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

from searchbench import run

TINY_SEARCH = {"H": 32, "K": 32, "population": 64, "fused_chunk": 3}
TINY_INGEST = {"H": 32, "order_mode_max_l": 512}
TINY_FLEET = {"campaigns": 3, "stored_runs": 12, "staged_runs": 40,
              "searches_per_campaign": 0, "think_mean_s": 0.2}
TINY_CI = {"campaigns": 3, "stored_runs": 5, "staged_runs": 4,
           "searches_per_campaign": 4, "campaigns_per_slot": 12,
           "distinct_histories": 4, "think_mean_s": 0.1}


def tiny_checkout(tmp: Path, base: str = "zk2212-delay",
                  traffic: Optional[dict] = None, search: dict = TINY_SEARCH,
                  ingest: dict = TINY_INGEST, limits: Optional[dict] = None,
                  metric: str = "") -> Path:
    """A copy of ``BENCHMARK.json`` and ``searchbench/`` under ``tmp``
    with the cell ``tiny.cell``: configuration ``tiny`` (``base`` cut to
    ``search``/``ingest`` and 3 generations, with ``limits`` where
    given), traffic ``tiny`` and, with ``metric``, a per-layer metric of
    that name reading the window's request count; all added as files
    and entries alone."""
    root = Path(tmp)
    pkg = root / "searchbench"
    shutil.copytree(run.HERE, pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((pkg / "configs" / f"{base}.json").read_text())
    cfg["search_params"].update(search)
    cfg["ingest_params"].update(ingest)
    if limits:
        cfg["limits"] = dict(limits)
    cfg["generations"] = 3
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "tiny.json").write_text(
        json.dumps(traffic or TINY_FLEET))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "searchbench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "tests"})
    if metric:
        (pkg / "metrics" / f"{metric}.py").write_text(
            "def read(run):\n    return float(len(run.window))\n")
        bench["per_layer"].append({
            "name": metric, "unit": "requests", "better": "higher",
            "source": "host_clock", "layer": "sidecar",
            "moves": "searches_per_s", "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def tiny_run(root: Path, seed: int = 3, seconds: float = 3.0,
             controls=()) -> dict:
    """One untraced run of ``tiny.cell`` of the checkout ``root`` on the
    CPU."""
    cell = run.load_cell("tiny.cell", False, root, root / "searchbench")
    return run.run_once(cell, seed, seconds, False, device="cpu",
                        controls=controls)
