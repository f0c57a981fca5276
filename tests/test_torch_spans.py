"""The port's spans at the dispatch and solve-serving boundaries, on the
CPU: ``engine.launches`` around each schedule's loop of wrapper calls,
request ids that follow one request across ``serve.submit``,
``serve.block`` and ``serve.result_copy``, the marks the spans leave on
``torch.profiler``'s timeline, and the disabled path's cost."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import engine as TE
from repro_torch.core import stencil as TS
from repro_torch.engine import dispatch
from repro_torch.obs import metrics as TM
from repro_torch.obs import trace as TO
from repro_torch.serve import SolveRequest, SolveServer


def _grid(left=1.0, ny=14, nx=30):
    u = TS.make_laplace_problem(ny, nx, left=left, device="cpu")
    u[1:-1, 1:-1] = torch.rand((ny, nx), generator=torch.Generator()
                               .manual_seed(int(left * 100)))
    return u


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts calls of every registered policy's wrapper."""
    calls = []
    for name, p in list(dispatch._REGISTRY.items()):
        def fn(*a, _fn=p.fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setitem(dispatch._REGISTRY, name,
                            dataclasses.replace(p, fn=fn))
    return calls


def _launch_spans(tracer):
    return [e for e in tracer.events if e.name == "engine.launches"]


@pytest.mark.parametrize("entry", ["run", "run_converged", "run_batched"])
def test_engine_launches_nests_and_counts_the_wrapper_calls(entry,
                                                            wrapper_calls):
    spec = TS.jacobi_2d_5pt()
    tracer = TO.Tracer()
    with TO.use_tracer(tracer):
        if entry == "run":
            TE.run(_grid(), spec, iters=11, t=4)
        elif entry == "run_converged":
            TE.run_converged(_grid(), spec, tol=None, max_iters=24, t=8)
        else:
            with TO.span("caller"):
                TE.run_batched(torch.stack([_grid(), _grid(0.5)]), spec,
                               iters=11, t=4)
    spans = _launch_spans(tracer)
    parent = {"run": "engine.run", "run_converged": "engine.run_converged",
              "run_batched": "caller"}[entry]
    assert spans and all(e.path == (parent, "engine.launches") for e in spans)
    assert sum(e.attrs["launches"] for e in spans) == len(wrapper_calls)
    # run: 2 fused blocks and 3 remainder sweeps; run_converged: 3 blocks
    # of one fused launch each.
    assert len(wrapper_calls) == {"run": 5, "run_converged": 3,
                                  "run_batched": 5}[entry]
    outer = next(e for e in tracer.events if e.name == parent)
    for e in spans:
        assert outer.ts_us <= e.ts_us
        assert e.ts_us + e.dur_us <= outer.ts_us + outer.dur_us


def test_no_tracer_costs_one_lookup_per_schedule_and_none_per_launch(
        monkeypatch):
    """With no tracer, every span is the shared no-op, and the tracer is
    looked up once a span site: a run of 20 launches looks it up as often
    as a run of 2."""
    assert TO.span("engine.launches", launches=3) is TO.NULL_SPAN
    assert TO.get_tracer() is None

    class Lookups:
        n = 0

        def get(self):
            self.n += 1
            return None
    spec = TS.jacobi_2d_5pt()
    counts = []
    for iters in (4, 40):
        lookups = Lookups()
        monkeypatch.setattr(TO, "_TRACER", lookups)
        TE.run(_grid(), spec, iters=iters, t=2)
        counts.append(lookups.n)
    # engine.run, engine.build_schedule and engine.launches.
    assert counts == [3, 3]


def test_request_ids_follow_each_request_across_the_serve_spans():
    """Batched and lone: each admitted request gets the next id, one
    ``serve.submit`` and one ``serve.result_copy`` carry it, and the
    ``serve.block`` spans that carry it start after its submission."""
    tracer = TO.Tracer()
    srv = SolveServer(max_slots=2, superblock=2, torch_device="cpu",
                      tracer=tracer)
    reqs = [SolveRequest(grid=_grid(left), tol=tol, max_iters=n,
                         policy="temporal", t=8)
            for left, tol, n in ((1.0, 5e-2, 96), (0.5, 2.5e-2, 96),
                                 (0.25, None, 24))]
    srv.solve(reqs)
    lone = srv.submit(SolveRequest(grid=_grid(0.75), tol=None, max_iters=16,
                                   policy="temporal", t=8))
    srv.drain()
    assert [r.id for r in reqs + [lone]] == [0, 1, 2, 3]
    recs = TO.span_records(tracer)
    blocks = [r for r in recs if r["name"] == "serve.block"]
    assert any(not b["attrs"].get("lone") for b in blocks)
    assert any(b["attrs"].get("lone") and b["attrs"]["requests"] == [3]
               for b in blocks)
    for req in reqs + [lone]:
        submits = [r for r in recs if r["name"] == "serve.submit"
                   and r["attrs"]["request"] == req.id]
        copies = [r for r in recs if r["name"] == "serve.result_copy"
                  and r["attrs"]["request"] == req.id]
        carried = [b for b in blocks if req.id in b["attrs"]["requests"]]
        assert len(submits) == 1 and len(copies) == 1 and carried
        assert copies[0]["attrs"]["bytes"] == req.result.nbytes
        assert copies[0]["path"][-2:] == ("serve.block", "serve.result_copy")
        assert min(b["ts_us"] for b in carried) >= submits[0]["ts_us"]
    assert not {"serve.active_slots", "serve.queue_depth",
                "serve.max_residual"} & set(TM.snapshot()["gauges"])


def test_a_rejected_request_gets_no_id():
    srv = SolveServer(torch_device="cpu")
    bad = SolveRequest(grid=_grid(), max_iters=0)
    with pytest.raises(ValueError):
        srv.submit(bad)
    assert bad.id is None
    assert srv.submit(SolveRequest(grid=_grid(), max_iters=8)).id == 0


def _host_events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CUDA]


@pytest.mark.parametrize("installed", [True, False])
def test_spans_mark_the_profiler_timeline_only_under_a_tracer(installed):
    """Under a CPU ``torch.profiler`` window a span is a host event that
    encloses the aten ops run inside it; with no tracer nothing marks."""
    spec = TS.jacobi_2d_5pt()
    u = _grid()
    tracer = TO.Tracer() if installed else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TO.use_tracer(tracer):
            TE.run(u, spec, iters=6, t=3)
    events = _host_events(prof)
    marks = [e for e in events if e[0] == "engine.launches"]
    if not installed:
        assert not marks and not any(n.startswith("engine.") for n, *_ in
                                     events)
        return
    assert len(marks) == 1 and {n for n, *_ in events} >= {
        "engine.run", "engine.build_schedule"}
    _, a, b = marks[0]
    inside = [n for n, s, e in events if a <= s and e <= b
              and n.startswith("aten::")]
    assert inside
    # The mark closes with its span, after it.
    span = _launch_spans(tracer)[0]
    assert (b - a) / 1e3 >= span.dur_us


def test_records_are_the_same_in_memory_and_reloaded(tmp_path):
    tracer = TO.Tracer()
    with TO.use_tracer(tracer):
        TE.run(_grid(), TS.jacobi_2d_5pt(), iters=6, t=3)
    path = tmp_path / "t.json"
    tracer.write_trace(str(path))
    live = TO.span_records(tracer)
    # The file holds the events in order of their start.
    assert sorted(live, key=lambda r: r["ts_us"]) == \
        TO.span_records(str(path))
    assert [r["ts_us"] for r in live] == [round(e.ts_us, 3)
                                          for e in tracer.events]


def test_the_tracer_imports_without_torch():
    """``obs.trace`` finds torch among the loaded modules; it never
    imports it, so a span on a tracer works in a process without it."""
    code = ("import sys; from repro_torch.obs import trace as T; "
            "tr = T.Tracer()\n"
            "with T.use_tracer(tr):\n"
            "    with T.span('a'):\n"
            "        pass\n"
            "assert 'torch' not in sys.modules and len(tr.events) == 1")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert res.returncode == 0, res.stderr
