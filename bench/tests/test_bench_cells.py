"""Runs of each cell driven on the CPU at a small size, past the
harness's look for a card: sound runs come out correct, and the control
and every planted fault the cell can have come out not correct."""
import time

import pytest
import torch

from bench import harness
from bench.tests import faults

BENCH = harness.load_benchmark()
#: The sizes a test run holds: the configuration's shapes, smaller.
SMALL = {"run": dict(ny=24, nx=40, iters=16),
         "serve": dict(ny=24, nx=40)}


def drive(cell, *, control=False, seconds=0.3, **over):
    entry, cfg_entry = harness.find_cell(BENCH, cell)
    cfg = harness.load_config(cfg_entry)
    traffic = harness.load_traffic(entry["traffic"])
    cfg.update(SMALL[traffic["entry"]], **over)
    if traffic["entry"] == "serve":
        traffic.update(max_iters=160)
    run = harness.Run(cell=cell, cfg=cfg, traffic=traffic,
                      seed=2 ** 31 + 17, seconds=seconds, trace=False,
                      device=torch.device("cpu"),
                      t_start=time.perf_counter(), control=control)
    out = harness.drive(run)
    return out, harness.result_line(BENCH, run, out, entry["chips"])


@pytest.fixture
def planted():
    yield faults
    faults.undo()


@pytest.mark.parametrize("cell", ["jacobi-bf16.fixed", "jacobi-f32.fixed",
                                  "jacobi-f32.served"])
def test_sound_runs_are_correct(cell):
    out, line = drive(cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in
                                    harness.metrics_for(BENCH, cell, False)}
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", ["jacobi-bf16.fixed", "jacobi-f32.fixed",
                                  "jacobi-f32.served"])
def test_the_control_is_not_correct(cell):
    _, line = drive(cell, control=True, seconds=0.05)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("jacobi-bf16.fixed", "unchanged_step"),
    ("jacobi-bf16.fixed", "altered_answer"),
    ("jacobi-f32.fixed", "unchanged_step"),
    ("jacobi-f32.fixed", "altered_answer"),
    ("jacobi-f32.served", "unchanged_step"),
    ("jacobi-f32.served", "altered_answer"),
    ("jacobi-f32.served", "half_batch"),
])
def test_planted_faults_are_not_correct(planted, cell, fault):
    getattr(planted, fault)()
    _, line = drive(cell)
    assert not line["correct"], line["checks"]

