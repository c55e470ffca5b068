"""The judgement fails a broken timed path, and its controls: a run on
the CPU at a tiny size with a fault, or TF32 distances, planted in the
port under the harness (``control.PLANTS``)."""

import pytest

from searchbench import control, run, tiny

FAULTS = ("no_evolution", "half_scored", "archive_unchanged",
          "half_references", "answer_altered")


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_is_not_correct(tmp_path, monkeypatch, fault):
    control.PLANTS[fault](monkeypatch.setattr)
    out = tiny.tiny_run(tiny.tiny_checkout(tmp_path))
    assert out["result"]["correct"] is False


def test_tf32_in_the_program_is_not_correct(tmp_path, monkeypatch):
    # the scorer's distances as a TF32 matrix product, judged by the
    # run's own checks against the delay cell's limits
    control.PLANTS["tf32"](monkeypatch.setattr)
    limits = run.load_cell("zk2212-delay.solo", False).config["limits"]
    out = tiny.tiny_run(tiny.tiny_checkout(tmp_path, limits=limits))
    assert out["checks"]["fitness_gap"]["value"] > limits["fitness_gap"]
    assert out["result"]["correct"] is False
