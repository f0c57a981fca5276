"""The port's schedule and dispatch against the JAX package's.

Schedules equal the reference's field for field; ``run``,
``run_batched`` and ``run_converged`` agree with the reference within
``tests/test_engine.py``'s tolerances (the JAX side in interpret mode on
``cpu_ref``), and the port's own contracts (a batch lane equals its solo
run, donation changes nothing) hold bit for bit.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core import stencil as JS
from repro_torch import engine as TE
from repro_torch.core import stencil as TS
from repro_torch.interop import grid_from_numpy, grid_to_numpy
from repro_torch.obs.trace import Tracer, use_tracer

SPECS = {
    "jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
    "laplace9": (JS.laplace_2d_9pt(), TS.laplace_2d_9pt()),
    "advection2d": (JS.advection_2d_3pt(), TS.advection_2d_3pt()),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _problem(ny, nx, dtype="float32", seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (ny + 2, nx + 2) if batch is None else (batch, ny + 2, nx + 2)
    a = np.zeros(shape, np.float32)
    a[..., :, 0] = 1.0
    a[..., 1:-1, 1:-1] = rng.uniform(0, 1, shape[:-2] + (ny, nx))
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), grid_from_numpy(a, device="cpu").to(td)


def _close(ju, tu, dtype):
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(grid_to_numpy(tu.to(torch.float32)),
                               np.asarray(ju.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("policy", ["auto", "temporal", "rowchunk", "dbuf",
                                    "shifted", "reference"])
def test_schedule_equals_reference_field_for_field(policy):
    spec = (JS.laplace_2d_9pt(), TS.laplace_2d_9pt())
    for iters, t in [(19, 4), (1003, None), (7, 8), (0, None), (1, None),
                     (16, 8)]:
        kw = dict(shape=(66, 130), policy=policy, t=t, device="cpu_ref")
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = JE.build_schedule(iters, spec=spec[0], dtype=jnp.float32,
                                     **kw)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = TE.build_schedule(iters, spec=spec[1], dtype=torch.float32,
                                    **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.describe() == want.describe()
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


def test_effective_depth_and_overlap_feasible_match_reference():
    from repro.engine.schedule import overlap_feasible as j_of
    from repro_torch.engine.schedule import overlap_feasible as t_of
    for iters, t in [(0, None), (5, 8), (100, 3), (9, 1)]:
        assert TE.effective_depth(iters, t) == JE.effective_depth(iters, t)
    with pytest.raises(TE.PlanError):
        TE.effective_depth(4, 0)
    for args in [(10, 10, 4, 2), (8, 10, 4, 2), (10, 10, 4, 1)]:
        assert t_of(*args) == j_of(*args)


def test_paper_grid_schedule_on_the_card_model():
    """On gpu_sm90 the 2-D plan lets auto pick temporal: 125 x 8 + 3."""
    spec = TS.jacobi_2d_5pt()
    for dtype in (torch.bfloat16, torch.float32):
        sched = TE.build_schedule(1003, spec=spec, shape=(1026, 9218),
                                  dtype=dtype, device="gpu_sm90")
        assert (sched.policy, sched.t, sched.fused_blocks, sched.remainder,
                sched.remainder_policy) == ("temporal", 8, 125, 3,
                                            "rowchunk")
        assert TE.resolve_auto((1026, 9218), dtype, spec, iters=1,
                               device="gpu_sm90") == "dbuf"
    # The reference's planner demotes the same grid to shifted there.
    assert JE.resolve_auto((1026, 9218), jnp.bfloat16, JS.jacobi_2d_5pt(),
                           iters=1003, device="gpu_sm90") == "shifted"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_run_matches_reference(spec_name, dtype):
    js, ts = SPECS[spec_name]
    ju, tu = _problem(30, 62, dtype, seed=1)
    want = JE.run(ju, js, policy="auto", iters=19, t=4, bm=10,
                  interpret=True, device="cpu_ref")
    got = TE.run(tu, ts, policy="auto", iters=19, t=4, bm=10,
                 device="cpu_ref")
    _close(want, got, dtype)


@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal", "reference"])
def test_run_each_policy_matches_reference(policy):
    js, ts = SPECS["jacobi5"]
    ju, tu = _problem(22, 62, seed=2)
    want = JE.run(ju, js, policy=policy, iters=5, t=2, bm=11,
                  interpret=True, device="cpu_ref")
    got = TE.run(tu, ts, policy=policy, iters=5, t=2, bm=11,
                 device="cpu_ref")
    _close(want, got, "float32")


def test_run_donate_and_zero_iters():
    ts = TS.laplace_2d_9pt()
    _, tu = _problem(22, 62, seed=3)
    want = TE.run(tu, ts, iters=7, t=3)
    assert torch.equal(TE.run(tu.clone(), ts, iters=7, t=3, donate=True),
                       want)
    assert torch.equal(TE.run(tu, ts, iters=0), tu)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_run_batched_lane_equals_solo_and_reference(dtype):
    js, ts = SPECS["laplace9"]
    jus, tus = _problem(22, 62, dtype, seed=4, batch=3)
    got = TE.run_batched(tus, ts, iters=19, t=4, bm=11, device="cpu_ref")
    for i in range(3):
        solo = TE.run(tus[i].clone(), ts, iters=19, t=4, bm=11,
                      device="cpu_ref")
        assert torch.equal(got[i], solo)
    want = JE.run_batched(jus, js, iters=19, t=4, bm=11, interpret=True,
                          device="cpu_ref")
    _close(want, got, dtype)
    with pytest.raises(TE.PlanError, match=r"\(B, H, W\)"):
        TE.run_batched(tus[0], ts)


@pytest.mark.parametrize("tol", [None, 0.05, 1e-3])
def test_run_converged_matches_reference(tol):
    js, ts = SPECS["jacobi5"]
    ju, tu = _problem(30, 62, seed=5)
    want_u, want_n, want_r = JE.run_converged(
        ju, js, tol=tol, max_iters=19, t=4, bm=10, interpret=True,
        device="cpu_ref")
    got_u, got_n, got_r = TE.run_converged(tu, ts, tol=tol, max_iters=19,
                                           t=4, bm=10, device="cpu_ref")
    assert got_n == want_n and got_n % 4 == 0 and got_n <= 16
    np.testing.assert_allclose(got_r, want_r, rtol=1e-5, atol=1e-6)
    _close(want_u, got_u, "float32")
    # The reported residual is the final grid's, and the input survives.
    assert got_r == float(TS.residual(got_u, ts))
    assert torch.equal(tu, _problem(30, 62, seed=5)[1])


def test_run_converged_rounds_tol_to_nearest_f32():
    """tol is compared as the nearest f32, as the reference does: a
    residual equal to that f32 exits, whatever side of it tol fell."""
    ts = TS.jacobi_2d_5pt()
    _, tu = _problem(14, 30, seed=6)
    u1 = TE.run(tu, ts, iters=2, t=2)
    r1 = float(TS.residual(u1, ts))
    below = np.nextafter(r1, 0.0)  # f64 just under, rounds up to r1
    _, n, _ = TE.run_converged(tu, ts, tol=float(below), max_iters=8, t=2)
    assert n == 2
    _, n, r = TE.run_converged(tu, ts, tol=None, max_iters=9, t=2)
    assert n == 8 and r > 0


def test_step_auto_is_one_sweep():
    ts = TS.jacobi_2d_5pt()
    _, tu = _problem(30, 62, seed=7)
    assert torch.equal(TE.step(tu, ts), TS.apply_stencil(tu, ts))
    assert torch.equal(TE.step(tu, ts, policy="temporal", t=2),
                       TE.run(tu, ts, policy="temporal", iters=2, t=2))


def test_registry_matches_reference():
    assert TE.available_policies() == JE.available_policies()
    spec = (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt())
    for jp, tp in zip(JE.registry(), TE.registry()):
        assert (tp.name, tp.fused, tp.paper_ref) == (jp.name, jp.fused,
                                                     jp.paper_ref)
        for db, t in [(2, 8), (4, 1)]:
            assert tp.bytes_per_point(spec[1], db, t) == \
                jp.bytes_per_point(spec[0], db, t)
    with pytest.raises(ValueError, match="rowchunk"):
        TE.get_policy("nope")


def test_unported_paths_raise():
    ts = TS.jacobi_2d_5pt()
    _, tu = _problem(14, 30, seed=8)
    from repro_torch.analysis import check_schedule
    from repro_torch.backends import lower
    # The Tensix program cross-check is ported with the backends: a
    # program lowered from the schedule it runs checks clean.
    sched = TE.build_schedule(4, spec=ts, shape=tu.shape, dtype=tu.dtype,
                              device="cpu_ref", torch_device="cpu")
    prog = lower(tu.shape, tu.dtype, ts, sched.policy,
                 t=sched.t if sched.fused else None, device="cpu_ref")
    assert check_schedule(sched, shape=tu.shape, device="cpu_ref",
                          program=prog).ok
    # The distributed executor's schedule is ported: t groups the sweeps
    # a halo exchange, as the reference's does.
    js = JS.jacobi_2d_5pt()
    got = TE.build_schedule(4, spec=ts, shape=tu.shape, dtype=tu.dtype,
                            policy="rowchunk", t=2, device="cpu_ref",
                            mesh_shape=(2,), exchange_cadence=True,
                            torch_device="cpu")
    want = JE.build_schedule(4, spec=js, shape=tu.shape, dtype=jnp.float32,
                             policy="rowchunk", t=2, device="cpu_ref",
                             mesh_shape=(2,), exchange_cadence=True)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.t, got.fused_blocks, got.exchanges) == (2, 2, 2)


def test_spans_keep_the_reference_names():
    ts = TS.jacobi_2d_5pt()
    _, tu = _problem(14, 30, seed=9)
    tracer = Tracer()
    with use_tracer(tracer):
        TE.run(tu, ts, iters=5, t=2)
        TE.run_converged(tu, ts, tol=None, max_iters=4, t=2)
    names = {e.name for e in tracer.events}
    assert {"engine.run", "engine.run_converged",
            "engine.build_schedule"} <= names
    run_ev = next(e for e in tracer.events if e.name == "engine.run")
    assert run_ev.attrs["policy"] == "temporal"
    assert (run_ev.attrs["fused_blocks"], run_ev.attrs["remainder"]) == (2, 1)
