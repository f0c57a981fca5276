"""The readers of the port's spans (``bench/spans.py``) on a synthetic
traced window: host µs a launch, a solve's prologue, a served request's
queue wait and its result copy, and None where their spans are absent."""
import pytest

from bench import harness

READERS = ("launch_host_us.solve", "solve_prologue_us.solve",
           "queue_wait_p95_ms.served", "result_copy_ms.served")


def _rec(name, ts, dur, path=None, **attrs):
    return {"name": name, "path": tuple(path or (name,)), "ts_us": ts,
            "dur_us": dur, "attrs": attrs}


def _fixed():
    """Two solves: prologues of 100 and 300 µs, 625 launches in 30000 µs
    and 625 in 32500 µs."""
    recs = []
    for t0, pro, loop in ((0.0, 100.0, 30000.0), (50000.0, 300.0, 32500.0)):
        recs.append(_rec("engine.launches", t0 + pro, loop,
                         ("engine.run", "engine.launches"), launches=625))
        recs.append(_rec("engine.build_schedule", t0 + 5, 20.0,
                         ("engine.run", "engine.build_schedule")))
        recs.append(_rec("engine.run", t0, pro + loop + 10))
    # A launch loop outside any engine.run (run_batched under a caller)
    # counts for the launches, not for the prologue.
    recs.append(_rec("engine.launches", 90000.0, 1250.0,
                     ("caller", "engine.launches"), launches=25))
    return {"span_records": recs}


def _served():
    """Requests 0-2 finish in the window; 3 is still queued at its end.
    Waits: 0 and 1 dispatched at once (1000 and 900 µs), 2 in the second
    block (40000 µs)."""
    recs = [_rec("serve.submit", 0.0, 50.0, request=0),
            _rec("serve.submit", 100.0, 50.0, request=1),
            _rec("serve.submit", 200.0, 50.0, request=2),
            _rec("serve.block", 1000.0, 30000.0, requests=[0, 1]),
            _rec("serve.result_copy", 29000.0, 20000.0,
                 ("serve.block", "serve.result_copy"), request=0, bytes=8),
            _rec("serve.block", 40200.0, 30000.0, requests=[1, 2]),
            _rec("serve.result_copy", 60000.0, 10000.0,
                 ("serve.block", "serve.result_copy"), request=1, bytes=8),
            _rec("serve.block", 80000.0, 5000.0, requests=[2], lone=True),
            _rec("serve.result_copy", 84000.0, 30000.0,
                 ("serve.block", "serve.result_copy"), request=2, bytes=8),
            _rec("serve.submit", 90000.0, 50.0, request=3)]
    return {"span_records": recs}


def test_fixed_cell_readers():
    ctx = _fixed()
    got = harness.reader("launch_host_us.solve")(ctx)
    assert got == pytest.approx((30000 + 32500 + 1250) / 1275)
    assert harness.reader("solve_prologue_us.solve")(ctx) == \
        pytest.approx(200.0)


def test_served_cell_readers():
    ctx = _served()
    # Nearest rank over [1000, 900, 40000]: the largest.
    assert harness.reader("queue_wait_p95_ms.served")(ctx) == \
        pytest.approx(40.0)
    assert harness.reader("result_copy_ms.served")(ctx) == \
        pytest.approx(20.0)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("ctx", [{}, {"span_records": []},
                                 {"busy_s": 1.0, "trace_window_s": 2.0},
                                 "other_cell"])
def test_readers_find_nothing_without_their_spans(name, ctx):
    if ctx == "other_cell":
        # Each cell's spans are absent from the other's window.
        ctx = _served() if name.endswith(".solve") else _fixed()
    assert harness.reader(name)(ctx) is None
