"""A cell is data: a configuration, a traffic mix and a metric added as
files (and entries) alone run; the command refuses to run without a
card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from searchbench import run, tiny


def test_new_files_alone_run_a_cell(tmp_path):
    root = tiny.tiny_checkout(tmp_path, metric="tiny_requests")
    cell = run.load_cell("tiny.cell", True, root, root / "searchbench")
    assert [m["name"] for m in cell.metrics][-1] == "tiny_requests"
    data = run.RunData([{}] * 7, 0.0, 1.0, 0.0, None)
    assert run.reader("tiny_requests", cell.pkg)(data) == 7.0
    out = tiny.tiny_run(root)
    assert out["result"]["correct"] is True
    assert set(out["result"]["metrics"]) == {"searches_per_s", "setup_s"}


def test_every_cell_names_its_files():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        for traced in (False, True):
            cell = run.load_cell(w["name"], traced)
            for m in cell.metrics:
                assert callable(run.reader(m["name"]))
            assert cell.config["limits"]


def _command(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "searchbench", "--workload",
         "zk2212-delay.solo", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    p = _command(run.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "searchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "searchbench", "--workload",
         "zk2212-delay.solo", "--seed", "7", "--seconds", "10",
         "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
