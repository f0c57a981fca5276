"""The port's trace reconciliation and trace CLI against the JAX package's.

``reconcile`` on the same trace gives the reference's ``DriftReport``
(components, drift, diagnostics, text), in memory or reloaded from a
file; ``python -m repro_torch.obs validate|summarize`` reads a trace
written by ``launch/solve.py --serve --device cpu --trace`` and prints
what ``python -m repro.obs`` prints; the port's solve server emits the
reference's span and counter names with the same attrs, and beside them
its request ids and result copies (``tests/test_torch_spans.py``).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import __main__ as JCLI
from repro.obs import compare as JC
from repro.obs import trace as JO
from repro.serve import SolveRequest as JRequest
from repro.serve import SolveServer as JServer
from repro_torch.interop import grid_from_numpy
from repro_torch.obs import __main__ as TCLI
from repro_torch.obs import compare as TC
from repro_torch.obs import trace as TO
from repro_torch.serve import SolveRequest, SolveServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _synthetic():
    """A Chrome trace whose spans carry model_s attrs: close, drifting
    both ways, zero, missing, and not a number."""
    events = []
    ts = 0.0

    def span(name, dur_us, **args):
        nonlocal ts
        events.append({"name": name, "cat": "repro", "ph": "X", "ts": ts,
                       "dur": dur_us, "pid": 1, "tid": 1,
                       "args": dict(args, _path=name)})
        ts += dur_us
    for _ in range(3):
        span("exchange", 1000.0, model_s=1.1e-3)
        span("interior", 500.0, model_s=2e-4)
        span("rind", 100.0, model_s=1e-3)
    span("sim", 50.0, model_s=0.0)
    span("odd", 10.0, model_s="n/a")
    span("engine.run", 70.0)
    events.append({"name": "serve.slots", "cat": "repro", "ph": "C",
                   "ts": ts, "pid": 1, "tid": 1,
                   "args": {"active": 2.0, "queue": 1.0}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _same(j, t):
    assert t.describe() == j.describe()
    assert [(c.component, c.spans, c.measured_s, c.modeled_s)
            for c in t.components] == \
        [(c.component, c.spans, c.measured_s, c.modeled_s)
         for c in j.components]
    assert [c.component for c in t.drifting] == \
        [c.component for c in j.drifting]
    assert [(d.severity, d.code, d.span, d.message, d.hint)
            for d in t.report.diagnostics] == \
        [(d.severity, d.code, d.span, d.message, d.hint)
         for d in j.report.diagnostics]
    assert t.tolerance == j.tolerance


@pytest.mark.parametrize("tolerance", [1.05, 2.0, 10.0])
def test_reconcile_equals_the_reference(tolerance):
    trace = _synthetic()
    _same(JC.reconcile(trace, tolerance=tolerance),
          TC.reconcile(trace, tolerance=tolerance))
    assert TC.MODEL_ATTR == JC.MODEL_ATTR == "model_s"


def test_reconcile_of_an_empty_or_unmodeled_trace_equals_the_reference():
    for trace in ({"traceEvents": []},
                  {"traceEvents": _synthetic()["traceEvents"][-2:]}):
        j, t = JC.reconcile(trace), TC.reconcile(trace)
        _same(j, t)
        assert [d.code for d in t.report.diagnostics] == ["OBS-UNMODELED"]


def test_reconcile_of_a_file_equals_the_live_tracer(tmp_path):
    tracer = TO.Tracer()
    with TO.use_tracer(tracer):
        for model in (1e-3, 5e-4):
            with TO.span("exchange", model_s=model):
                pass
    path = tmp_path / "t.json"
    tracer.write_trace(str(path))
    live, reloaded = TC.reconcile(tracer), TC.reconcile(str(path))
    assert [(c.component, c.spans, c.modeled_s) for c in live.components] \
        == [(c.component, c.spans, c.modeled_s)
            for c in reloaded.components]
    assert [d.code for d in live.report.diagnostics] == \
        [d.code for d in reloaded.report.diagnostics]
    _same(JC.reconcile(str(path)), reloaded)


def _cli(*args, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_reads_a_served_trace(tmp_path):
    path = tmp_path / "serve.json"
    res = _cli("-m", "repro_torch.launch.solve", "--ny", "30", "--nx", "62",
               "--iters", "48", "--t", "8", "--tol", "1e-3", "--serve",
               "--device", "cpu", "--check", "--trace", str(path))
    assert res.returncode == 0, res.stderr
    for want in ("bucket: 32x64 float32 temporal t=8", "serve=1",
                 "iters=48/48", "evicted_early=0", "launches=1", "GPt/s=",
                 "residual=", "CHECK OK", "[serve] launch=0", "OBS-UNMODELED"):
        assert want in res.stdout, (want, res.stdout)
    val = _cli("-m", "repro_torch.obs", "validate", str(path))
    assert val.returncode == 0 and " ok " in val.stdout, val.stdout
    summ = _cli("-m", "repro_torch.obs", "summarize", str(path))
    assert summ.returncode == 0, summ.stderr
    for want in ("serve.block", "serve.submit", "engine.run_converged",
                 "counter tracks: serve.slots", "OBS-UNMODELED"):
        assert want in summ.stdout, (want, summ.stdout)


def test_cli_serve_without_device_cpu_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI default serves on it")
    res = _cli("-m", "repro_torch.launch.solve", "--ny", "14", "--nx", "30",
               "--iters", "8", "--serve")
    assert res.returncode != 0 and "cuda" in res.stderr
    assert "bucket:" not in res.stdout


def test_validate_and_summarize_print_what_the_reference_prints(
        tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_synthetic()))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "ts": 0}]}))
    missing = tmp_path / "none.json"
    for path in (good, bad, missing):
        codes = []
        outs = []
        for cli in (JCLI, TCLI):
            codes.append(cli.validate(str(path)))
            outs.append(capsys.readouterr().out)
        assert codes[1] == codes[0] and outs[1] == outs[0]
    assert [TCLI.validate(str(p)) for p in (good, bad, missing)] == [0, 1, 1]
    capsys.readouterr()
    outs = []
    for cli in (JCLI, TCLI):
        assert cli.summarize(str(good), tolerance=2.0) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and "OBS-DRIFT" in outs[1]


def _problem(scale):
    u = np.zeros((18, 18), np.float32)
    u[:, 0] = 1.0
    u[1:-1, 1:-1] = np.random.default_rng(7).uniform(0, 1, (16, 16))
    return u * np.float32(scale)


def test_server_spans_and_counters_equal_the_reference():
    """One workload through both servers: restricted to the reference's
    span names and attr keys, the same serve.* spans in the same order
    with the same attrs (max_residual within f32 rounding), and the same
    serve.slots counter samples. Beyond them the port has only its
    request ids (``request``, ``requests``) and the ``serve.result_copy``
    spans."""
    cases = [(1.0, 5e-2, 96), (0.5, 2.5e-2, 96), (0.25, None, 24)]
    jtr, ttr = JO.Tracer(), TO.Tracer()
    JServer(max_slots=2, superblock=2, interpret=True, tracer=jtr).solve(
        [JRequest(grid=jnp.asarray(_problem(s)), tol=tol, max_iters=n,
                  policy="temporal", t=8) for s, tol, n in cases])
    SolveServer(max_slots=2, superblock=2, torch_device="cpu",
                tracer=ttr).solve(
        [SolveRequest(grid=grid_from_numpy(_problem(s), device="cpu"),
                      tol=tol, max_iters=n, policy="temporal", t=8)
         for s, tol, n in cases])

    def served(recs):
        return [r for r in recs if r["name"].startswith("serve.")]
    jrecs = served(JO.span_records(jtr))
    trecs = served(TO.span_records(ttr))
    jnames = {r["name"] for r in jrecs}
    kept = [r for r in trecs if r["name"] in jnames]
    assert [r["name"] for r in kept] == [r["name"] for r in jrecs]
    extra_keys = set()
    for t, j in zip(kept, jrecs):
        extra_keys |= set(t["attrs"]) - set(j["attrs"])
        assert {k: v for k, v in t["attrs"].items()
                if k in j["attrs"] and k != "max_residual"} == \
            {k: v for k, v in j["attrs"].items() if k != "max_residual"}
    np.testing.assert_allclose(
        [r["attrs"]["max_residual"] for r in kept
         if r["name"] == "serve.block"],
        [r["attrs"]["max_residual"] for r in jrecs
         if r["name"] == "serve.block"], rtol=1e-5)
    assert [(c["name"], c["values"]) for c in TO.counter_records(ttr)] == \
        [(c["name"], c["values"]) for c in JO.counter_records(jtr)]
    assert jnames == {"serve.submit", "serve.block"}
    assert {r["name"] for r in trecs} - jnames == {"serve.result_copy"}
    assert extra_keys == {"request", "requests"}
    assert any(r["attrs"].get("lone") for r in kept)
