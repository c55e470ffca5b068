"""The benchmark of ``namazu_tpu_torch``'s search sidecar on the card.

    python3 -m searchbench --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` (at the root of the checkout): a
fleet of campaigns (``fleet.py``) drives the ``search`` op of the port's
``SidecarServer``, started in this process on the card, over the framed
wire on loopback. Set-up writes the campaigns' storages from the seed,
loads the pair-distance kernel (built into ``build/namazu_tpu_torch/``
in the checkout at its first run there) and sends one warm request a
starting campaign; the window then lasts ``--seconds``. With ``--trace
1`` a stretch in the middle of the window is profiled and the cell's
per-layer metrics are reported, else its end-to-end metrics.

Once the window has closed and the device's peak memory has been read,
the sidecar is shut down and every answer is judged against the plain
reference (``reference/``): the fitness each returned table claims
against its campaign's history, worked out again from the storage, and
the table's own bounds; and the search of a share of the requests drawn
from the seed, from the populations it started and ended with
(``judge``, ``checks``). The result is one JSON line, the
last of standard output; the compared numbers and their limits are the
last lines of standard error.

Without a CUDA card (or with fewer than the cell asks for), or when the
process holds JAX or the JAX package once the window has closed, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules the run must not hold (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "namazu_tpu")
#: the traced stretch: where in the window it starts, and its length
STRETCH_AT = 0.35
STRETCH_S = 12.0
#: seconds a slot may take past the window's close for its last answer
JOIN_S = 300.0


def _process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


PROCESS_T0 = time.perf_counter() - _process_age()


def pin_caches(root: Path) -> None:
    """Keep every compile cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: List[dict]  # the BENCHMARK.json entries reported
    pkg: Path  # where the traffic files and metric readers are


def _applies(entry: dict, cell: str, reported: Sequence[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in reported if "moves" in entry else True


def load_cell(name: str, traced: bool, root: Path = ROOT,
              pkg: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its
    configuration, its traffic file (in ``pkg/traffic``) and the metrics
    it reports."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"searchbench: no workload {name!r} in "
                         f"BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(pkg / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    if traced:
        names = [m["name"] for m in e2e]
        metrics = [m for m in bench["per_layer"]
                   if _applies(m, name, names)]
    else:
        metrics = e2e
    return Cell(name, int(cell["chips"]), config, traffic, metrics, pkg)


def reader(metric: str, pkg: Path = HERE):
    """``read`` of ``pkg/metrics/<metric>.py``."""
    path = pkg / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"searchbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class RunData(NamedTuple):
    """What a metric reads: the window's requests (records of
    ``fleet.Fleet``, each with its B1 shape), the window's bounds on the
    host's clock, set-up seconds and the traced stretch (or None)."""

    window: List[dict]
    t_start: float
    t_end: float
    setup_s: float
    stretch: Optional[object]

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


def add_b1_shapes(records: List[dict], config: dict) -> None:
    """Each record's B1 launch shape ``(N, A, F, K)``: the population's
    rows times the reference runs, and the distinct rows each ring holds
    after the request's ingest (every visible run appended once a
    request; failures once each)."""
    from searchbench.roofline import ring_rows

    sp, ip = config["search_params"], config["ingest_params"]
    P, K = int(sp.get("population", 4096)), int(sp.get("K", 256))
    refs = int(ip.get("max_reference_traces", 4))
    written: Dict[int, int] = {}
    for r in sorted(records, key=lambda r: r["sent"]):
        n, nf = r["runs"], r["failures"]
        written[r["campaign"]] = written.get(r["campaign"], 0) + n
        T = min(refs, n - nf if n > nf else nf)
        r["b1_shape"] = (P * T, ring_rows(n, written[r["campaign"]], 512),
                         ring_rows(nf, nf, 64), K)


def _population(path: str) -> "np.ndarray":
    import numpy as np

    with np.load(path) as z:
        return np.array(z["pop_delays"], np.float32)


def judge(records: List[dict], config: dict,
          controls: Sequence[str] = ()) -> Dict[str, object]:
    """Every answer, and the search of every checked request, against
    the plain reference.

    ``gaps["f64"]``: the widest gap between a fitness the program gives
    and the reference's fitness of its table: each answer's, and each
    checked request's last generation's best (the final population's
    first row). ``missed``: the most by which a row of a checked
    request's starting population outscores its first generation's
    best. ``unchanged``: the largest share of a checked request's final
    population found in its starting population. ``bad``: the requests
    that got no sound answer (not ``ok``, a table of the wrong size, a
    value out of its bounds or not finite, generations not advanced as
    asked, no checkpoint or curve to check). ``controls`` may hold
    ``"tf32"``: the reading of the reference in the program's place one
    precision below the float32 it computes in, the widest gap between
    the reference's fitness in TF32 and in float64 over the same
    tables."""
    import numpy as np

    from searchbench.reference.campaign import (Campaign, check_search,
                                                judge as gap_of)
    from searchbench.reference.encode import Reader

    sp, ip = config["search_params"], config["ingest_params"]
    H = int(sp.get("H", 256))
    hi_d = float(np.float32(sp.get("max_interval", 0.1)))
    hi_f = float(np.float32(sp.get("max_fault", 0.0)))
    gen = int(config["generations"])
    reader_ = Reader(H)
    gaps = {p: 0.0 for p in ("f64",) + tuple(controls)}
    missed, unchanged = 0.0, 0.0
    bad, judged, searched = 0, 0, 0
    by_campaign: Dict[int, List[dict]] = {}
    for r in sorted(records, key=lambda r: r["sent"]):
        by_campaign.setdefault(r["campaign"], []).append(r)
    for recs in by_campaign.values():
        camp = Campaign(reader_, sp, ip)
        states, served, prev = [], 0, None
        for r in recs:
            states.append(camp.ingest(r["key"], r["runs"]))
            a = r["answer"]
            before, prev = prev, r
            if not r["ok"]:
                bad += 1
                continue
            d = np.asarray(a.get("delays", []), np.float64)
            f = np.asarray(a.get("faults", []), np.float64)
            served += gen
            if (d.shape != (H,) or f.shape != (H,)
                    or not np.isfinite(d).all() or not np.isfinite(f).all()
                    or not math.isfinite(a["fitness"])
                    or d.min() < 0 or d.max() > hi_d
                    or f.min() < 0 or f.max() > hi_f
                    or a.get("generations_run") != served
                    or len(r["fit_curve"] or ()) != gen):
                bad += 1
                continue
            judged += 1
            gaps["f64"] = max(gaps["f64"], gap_of(camp, states, a))
            if "tf32" in controls:
                t = np.asarray(a["delays"], np.float32)[None]
                gaps["tf32"] = max(gaps["tf32"], float(np.abs(
                    camp.fitness(states[-1], t, "tf32")
                    - camp.fitness(states[-1], t)).max()))
            if not r["checked"]:
                continue
            if (before is None or not before["checkpoint"]
                    or not r["checkpoint"]):
                bad += 1
                continue
            c = check_search(camp, states[-1],
                             _population(before["checkpoint"]),
                             _population(r["checkpoint"]), r["fit_curve"])
            searched += 1
            gaps["f64"] = max(gaps["f64"], c.best_gap)
            missed = max(missed, c.missed)
            unchanged = max(unchanged, c.unchanged)
            if "tf32" in controls:
                gaps["tf32"] = max(gaps["tf32"], float(np.abs(
                    camp.fitness(states[-1], c.tables, "tf32")
                    - c.fitness).max()))
    return {"gaps": gaps, "missed": missed, "unchanged": unchanged,
            "bad": bad, "judged": judged, "searched": searched}


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run_once(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: Optional[float] = None,
             controls: Sequence[str] = ()) -> dict:
    """Set up, measure and judge one run of ``cell``; returns ``{"result":
    the result's keys but the checks, "checks": the compared numbers,
    "judged": the judgement, "lateness": seconds each request was sent
    after it was due}``. ``t0``: the start of set-up on the host's clock
    (default: the process's start)."""
    import torch

    from namazu_tpu_torch.ops import _build
    from namazu_tpu_torch.sidecar import SidecarServer
    from searchbench import trace as tr
    from searchbench.fleet import Fleet

    t0 = PROCESS_T0 if t0 is None else t0
    if device == "cuda":
        _build.load("min_sq_pair")
    work = tempfile.mkdtemp(prefix="searchbench-")
    recorder = tr.Recorder()
    server = SidecarServer("127.0.0.1", 0, device=device,
                           telemetry=recorder)
    server.start()
    fleet = None
    try:
        t_imported = time.perf_counter()
        fleet = Fleet(cell.config, cell.traffic, seed, work, server.service)
        t_written = time.perf_counter()
        warm = fleet.warm_up(server.port)
        if not warm or not all(r["ok"] for r in warm):
            raise RuntimeError(f"a warm request failed: "
                               f"{[r['answer'] for r in warm][:2]}")
        _sync(device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        t_end = t_start + seconds
        threads = fleet.start(server.port, t_start, t_end)
        stretch = None
        if traced:
            at = t_start + STRETCH_AT * seconds
            time.sleep(max(0.0, at - time.perf_counter()))
            stretch = tr.capture(recorder, min(STRETCH_S, 0.3 * seconds),
                                 os.path.join(work, "trace.json"))
            os.remove(os.path.join(work, "trace.json"))
        joined = fleet.join(threads, t_end + JOIN_S)
        _sync(device)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        if fleet.exhausted:
            raise RuntimeError(
                f"the traffic ran out of written runs or campaigns "
                f"{fleet.exhausted} time(s): raise staged_runs or "
                f"campaigns_per_slot in traffic/{cell.name}")
        records = list(fleet.records)
        add_b1_shapes(records, cell.config)
        window = [r for r in records
                  if not r["warm"] and t_start <= r["due"] < t_end]
        data = RunData(window, t_start, t_end, t_start - t0, stretch)
        metrics = {}
        for m in cell.metrics:
            v = reader(m["name"], cell.pkg)(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                        else device),
               "count": cell.chips, "memory_peak_bytes": int(peak)}
        result = {"correct": False, "attempted": len(window),
                  "failed": sum(1 for r in window if not r["ok"]),
                  "metrics": metrics, "device": dev}
        if stretch is not None:
            dev["busy_s"] = tr.busy_seconds(stretch)
            dev["window_s"] = stretch.seconds
            result["breakdown"] = tr.breakdown(stretch)
    finally:
        server.shutdown()
        if fleet is None:
            shutil.rmtree(work, ignore_errors=True)
    del server, fleet
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    try:
        judged = judge(records, cell.config, controls)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phases = {"imports": t_imported - t0, "write": t_written - t_imported,
              "warm": t_start - t_written,
              "judge": time.perf_counter() - t_judge}
    limits = cell.config["limits"]
    checks = {
        "fitness_gap": {"value": judged["gaps"]["f64"],
                        "limit": limits["fitness_gap"]},
        "missed_gap": {"value": judged["missed"],
                       "limit": limits["missed_gap"]},
        "unchanged_share": {"value": judged["unchanged"],
                            "limit": limits["unchanged_share"]},
        "bad_answers": {"value": judged["bad"] + (0 if joined else 1),
                        "limit": limits["bad_answers"]},
    }
    result["correct"] = bool(
        judged["judged"] > 0 and judged["searched"] > 0
        and all(c["value"] <= c["limit"] for c in checks.values()))
    return {"result": result, "checks": checks, "judged": judged,
            "lateness": [r["sent"] - r["due"] for r in records
                         if not r["warm"]],
            "threads_mapped": (None if stretch is None
                               else len(stretch.threads)),
            "phases": phases}


def held_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m searchbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches(ROOT)
    cell = load_cell(args.workload, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"searchbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_once(cell, args.seed, args.seconds, bool(args.trace))
    held = held_forbidden()
    if held:
        print(f"searchbench: the process holds {held}; the port must run "
              f"without JAX or the JAX package", file=sys.stderr)
        return 3
    late = sorted(out["lateness"])
    print(f"# card: {card_line()}; requests sent after due: "
          f"median {late[len(late) // 2] if late else 0:.6f} s, "
          f"max {late[-1] if late else 0:.6f} s over {len(late)}; "
          f"traced threads mapped: {out['threads_mapped']}; "
          f"seconds: {json.dumps(out['phases'])}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = dict(out["result"], checks=out["checks"])
    print(json.dumps(line))
    return 0
