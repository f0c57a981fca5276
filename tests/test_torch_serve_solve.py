"""The port's SolveServer against the JAX package's, on the same workloads.

The cases of ``tests/test_serve_solve.py`` and of the server part of
``tests/test_device_resident.py``: each workload (numpy grids from a
seed) goes through the JAX server (interpret mode on ``cpu_ref``) and the
port's (``torch_device="cpu"``, the kernels' plain versions). Realized
iteration counts, convergence and bucket counts must equal the
reference's; every port result must equal the port's solo ``engine.run``
at its realized count bit for bit, and the JAX server's result within
``tests/test_engine.py``'s tolerances (f32 1e-6, bf16 2e-2). The spans
and counters are held in ``tests/test_torch_obs.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencil as JS
from repro.serve import SolveRejected as JRejected
from repro.serve import SolveRequest as JRequest
from repro.serve import SolveServer as JServer
from repro_torch import engine as TE
from repro_torch.core import stencil as TS
from repro_torch.interop import grid_from_numpy, grid_to_numpy
from repro_torch.obs import metrics as TM
from repro_torch.serve import SolveRejected, SolveRequest, SolveServer
from repro_torch.serve import solve as TSolve

SPECS = {"jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
         "laplace9": (JS.laplace_2d_9pt(), TS.laplace_2d_9pt())}


def _problem(h, w, left=1.0, scale=1.0, seed=None):
    """A ringed Laplace problem as numpy: the hot left side at ``left``,
    the interior zero or (with ``seed``) uniform noise, all times
    ``scale``."""
    u = np.zeros((h + 2, w + 2), np.float32)
    u[:, 0] = left
    if seed is not None:
        u[1:-1, 1:-1] = np.random.default_rng(seed).uniform(0, 1, (h, w))
    return u * np.float32(scale)


def _pair(cases):
    """Each case (grid, kwargs) as a JAX request and a port request."""
    jreqs, treqs = [], []
    for grid, kw in cases:
        kw = dict(kw)
        dtype = kw.pop("dtype", "float32")
        js, ts = SPECS[kw.pop("spec", "jacobi5")]
        jgrid = jnp.asarray(grid).astype(getattr(jnp, dtype))
        tgrid = grid_from_numpy(grid, device="cpu").to(getattr(torch, dtype))
        jreqs.append(JRequest(grid=jgrid, spec=js, **kw))
        treqs.append(SolveRequest(grid=tgrid, spec=ts, **kw))
    return jreqs, treqs


def _serve(cases, **kw):
    jreqs, treqs = _pair(cases)
    jsrv = JServer(interpret=True, **kw)
    jsrv.solve(jreqs)
    tsrv = SolveServer(torch_device="cpu", **kw)
    tsrv.solve(treqs)
    return jsrv, jreqs, tsrv, treqs


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=1e-6, atol=1e-6))


def _agree(jsrv, jreqs, tsrv, treqs):
    """Counts equal the reference's; results bit for bit the port's solo
    run and within tolerance of the JAX server's."""
    assert len(tsrv.buckets) == len(jsrv.buckets)
    assert [k.describe() for k in tsrv.buckets] == \
        [k.describe() for k in jsrv.buckets]
    for j, t in zip(jreqs, treqs):
        assert t.done and j.done
        assert (t.iters_done, t.converged) == (j.iters_done, j.converged)
        assert (t.target_blocks, t.blocks_done) == \
            (j.target_blocks, j.blocks_done)
        assert t.key.t == j.key.t and t.key.policy == j.key.policy
        assert t.iters_done % t.key.t == 0
        assert 0 < t.iters_done <= t.max_iters
        assert t.result.device.type == "cpu"
        solo = TE.run(t.grid, t.spec, policy=t.key.policy,
                      iters=t.iters_done, t=t.key.t)
        assert torch.equal(t.result, solo)
        np.testing.assert_allclose(
            grid_to_numpy(t.result),
            np.asarray(j.result).astype(np.float32),
            **_tol(t.result.dtype))
        if t.tol is not None and t.converged:
            assert t.residual <= t.tol
        assert t.residual == pytest.approx(
            float(TE.residual_for(t.spec)(t.result)), rel=1e-6)
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts == js


def test_mixed_traffic():
    jsrv, jreqs, tsrv, treqs = _serve([
        (_problem(16, 16), dict(tol=3e-3, max_iters=96, policy="temporal",
                                t=8)),
        (_problem(16, 16), dict(tol=1.6e-3, max_iters=96, policy="temporal",
                                t=8)),
        (_problem(16, 16), dict(tol=None, max_iters=24, policy="temporal",
                                t=8)),
        (_problem(12, 20), dict(tol=2e-3, max_iters=96, policy="rowchunk",
                                t=8)),
        (_problem(16, 16), dict(spec="laplace9", tol=1.5e-3, max_iters=96,
                                policy="rowchunk", t=8)),
    ], max_slots=4)
    assert len(tsrv.buckets) == 3
    _agree(jsrv, jreqs, tsrv, treqs)
    assert all(r.converged for r in treqs if r.tol is not None)


def test_eviction_frees_slot_for_queued_request():
    jsrv, jreqs, tsrv, treqs = _serve(
        [(_problem(16, 16), dict(tol=tol, max_iters=96, policy="temporal",
                                 t=8))
         for tol in (5e-3, 3e-3, 2e-3, 1.5e-3, 1e-3)], max_slots=2)
    _agree(jsrv, jreqs, tsrv, treqs)
    stats = tsrv.stats()
    assert stats["completed"] == 5 and stats["evicted_early"] >= 1
    (per,) = stats["per_bucket"].values()
    assert per["peak_active"] <= 2
    assert stats["launches"] < sum(r.target_blocks for r in treqs)


def test_bucket_never_mixes_dtypes():
    jsrv, jreqs, tsrv, treqs = _serve([
        (_problem(16, 16), dict(tol=None, max_iters=8, policy="rowchunk",
                                t=8)),
        (_problem(16, 16), dict(dtype="bfloat16", tol=None, max_iters=8,
                                policy="rowchunk", t=8))], max_slots=4)
    f32, bf16 = treqs
    assert f32.key != bf16.key and len(tsrv.buckets) == 2
    assert (f32.key.dtype, bf16.key.dtype) == ("float32", "bfloat16")
    assert f32.result.dtype == torch.float32
    assert bf16.result.dtype == torch.bfloat16
    _agree(jsrv, jreqs, tsrv, treqs)


def test_bucket_mix_is_a_structured_diagnostic():
    """One SCHED-BUCKET-MIX finding per mismatching field, worded as the
    reference words it."""
    texts = []
    for server, request, rejected, grid in (
            (JServer(max_slots=2, interpret=True), JRequest, JRejected,
             jnp.asarray(_problem(16, 16))),
            (SolveServer(max_slots=2, torch_device="cpu"), SolveRequest,
             SolveRejected, grid_from_numpy(_problem(16, 16), device="cpu"))):
        req = server.submit(request(grid=grid, tol=None, max_iters=8,
                                    policy="rowchunk", t=8))
        bucket = server._buckets[req.key]
        foreign = dict(req.key.fields(), dtype="bfloat16", shape=(12, 22))
        with pytest.raises(rejected) as ei:
            bucket.admit(request(grid=grid), foreign)
        texts.append(str(ei.value))
    assert texts[1] == texts[0]
    assert texts[1].count("SCHED-BUCKET-MIX") == 2
    assert "bucket.dtype" in texts[1] and "bucket.shape" in texts[1]


@pytest.mark.parametrize("case", ["1-d", "no iters", "unknown policy"])
def test_infeasible_requests_are_structured_rejections(case):
    grid = {"1-d": np.zeros(16, np.float32)}.get(case, _problem(16, 16))
    kw = {"no iters": dict(max_iters=0),
          "unknown policy": dict(max_iters=8, policy="nonesuch")}.get(case,
                                                                     {})
    counter = "serve.rejected.SCHED-REQUEST-INFEASIBLE"
    before = TM.counter(counter).value
    with pytest.raises(JRejected) as je:
        JServer(max_slots=2, interpret=True).submit(
            JRequest(grid=jnp.asarray(grid), **kw))
    with pytest.raises(SolveRejected) as te:
        SolveServer(max_slots=2, torch_device="cpu").submit(
            SolveRequest(grid=grid, **kw))
    assert "SCHED-REQUEST-INFEASIBLE" in str(te.value)
    assert str(te.value).splitlines()[0] == str(je.value).splitlines()[0]
    if case != "unknown policy":  # the registries list their own modules
        assert str(te.value) == str(je.value)
    assert TM.counter(counter).value == before + 1


def test_a_block_that_cannot_plan_is_rejected_at_admission():
    """The port plans the block's kernel at admission: a depth whose halo
    leaves the compiled K1 no tile row is a structured rejection."""
    with pytest.raises(SolveRejected, match="SCHED-REQUEST-INFEASIBLE"):
        SolveServer(device="gpu_sm90", torch_device="cpu").submit(
            SolveRequest(grid=_problem(1024, 510), tol=1e-3, max_iters=1280,
                         policy="temporal", t=64))


def test_streaming_progress_per_block():
    seen = {"jax": [], "torch": []}
    jreqs, treqs = _pair([(_problem(16, 16), dict(
        tol=None, max_iters=32, policy="temporal", t=8,
        stream_iterates=True))])
    jreqs[0].stream = lambda r, p: seen["jax"].append(p)
    treqs[0].stream = lambda r, p: seen["torch"].append(p)
    JServer(max_slots=1, interpret=True).solve(jreqs)
    SolveServer(max_slots=1, torch_device="cpu").solve(treqs)
    assert [p.iters_done for p in seen["torch"]] == [8, 16, 24, 32]
    assert [p.iters_done for p in seen["torch"]] == \
        [p.iters_done for p in seen["jax"]]
    residuals = [p.residual for p in seen["torch"]]
    assert residuals == sorted(residuals, reverse=True)
    for jp, tp in zip(seen["jax"], seen["torch"]):
        assert tp.residual == pytest.approx(jp.residual, rel=1e-5)
        assert tp.iterate.device.type == "cpu"
        np.testing.assert_allclose(grid_to_numpy(tp.iterate),
                                   np.asarray(jp.iterate), rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(seen["torch"][-1].iterate, treqs[0].result)


def test_server_warm_never_remeasures(tmp_path, monkeypatch):
    from repro_torch.engine import tune
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "tune.json"))
    tune.clear()
    srv = SolveServer(max_slots=2, torch_device="cpu")
    shapes = [(18, 18), (14, 22)]
    won = srv.warm(shapes, iters=8, t=4)
    assert set(won) == set(shapes) and set(srv.warmed) == set(shapes)
    before = tune.cache_info()["measure_count"]
    assert srv.warm(shapes, iters=8, t=4) == won
    assert tune.cache_info()["measure_count"] == before
    req = srv.submit(SolveRequest(grid=_problem(16, 16), tol=None,
                                  max_iters=8, policy="tuned", t=4))
    assert tune.cache_info()["measure_count"] == before
    assert req.key.policy == won[(18, 18)]
    srv.drain()
    assert torch.equal(req.result, TE.run(req.grid, policy=won[(18, 18)],
                                          iters=8, t=4))
    tune.clear()


def _resident():
    return [(_problem(16, 16, seed=7), dict(tol=5e-2, max_iters=96,
                                            policy="temporal", t=8)),
            (_problem(16, 16, seed=7, scale=0.5),
             dict(tol=2.5e-2, max_iters=96, policy="temporal", t=8)),
            (_problem(16, 16, seed=7, scale=0.25),
             dict(tol=None, max_iters=24, policy="temporal", t=8))]


@pytest.mark.parametrize("superblock", [1, 2, 4])
def test_superblock_lanes_match_the_reference(superblock):
    jsrv, jreqs, tsrv, treqs = _serve(_resident(), max_slots=4,
                                      superblock=superblock)
    _agree(jsrv, jreqs, tsrv, treqs)


def test_superblock_sizes_are_equivalent():
    _, _, _, one = _serve(_resident(), max_slots=4, superblock=1)
    _, _, srv, four = _serve(_resident(), max_slots=4, superblock=4)
    for a, b in zip(one, four):
        assert (a.iters_done, a.residual, a.converged) == \
            (b.iters_done, b.residual, b.converged)
        assert torch.equal(a.result, b.result)
    assert srv.stats()["launches"] <= 4


def test_lone_request_bypasses_slot_machinery():
    case = [(_problem(16, 16), dict(tol=3e-2, max_iters=96,
                                    policy="temporal", t=8))]
    jsrv, jreqs, tsrv, treqs = _serve(case, max_slots=4, superblock=4)
    _agree(jsrv, jreqs, tsrv, treqs)
    assert tsrv.stats()["launches"] == 1
    (twin,) = _pair(case)[1]
    seen = []
    twin.stream = lambda r, p: seen.append(p.iters_done)
    SolveServer(max_slots=4, superblock=4, torch_device="cpu").solve([twin])
    req = treqs[0]
    assert (req.iters_done, req.residual) == (twin.iters_done, twin.residual)
    assert torch.equal(req.result, twin.result)
    assert seen == sorted(seen) and seen[-1] == twin.iters_done


def test_lone_request_narrows_tol_like_the_batch():
    """The bypass narrows ``tol`` to the largest f32 at or below it, as the
    superblock path does: a tol a hair under the residual after 3 blocks,
    whose nearest f32 is that residual, must not stop there."""
    grid = _problem(16, 16)
    res = float(TE.residual_for()(TE.run(grid_from_numpy(grid, device="cpu"),
                                         policy="temporal", iters=24, t=8)))
    tol = res * (1 - 1e-9)
    assert np.float32(tol) == np.float32(res) > TSolve._tol_f32(tol)
    case = [(grid, dict(tol=tol, max_iters=96, policy="temporal", t=8))]
    jsrv, jreqs, tsrv, treqs = _serve(case, max_slots=4)
    _agree(jsrv, jreqs, tsrv, treqs)
    (twin,) = _pair(case)[1]
    twin.stream = lambda r, p: None   # forces the superblock path
    SolveServer(max_slots=4, torch_device="cpu").solve([twin])
    assert treqs[0].iters_done == twin.iters_done > 24


def test_async_admission_between_superblocks():
    jreqs, treqs = _pair(_resident()[:2])
    jlate, tlate = _pair([(_problem(16, 16, seed=7, scale=0.75),
                           dict(tol=4e-2, max_iters=96, policy="temporal",
                                t=8))])
    jsrv = JServer(max_slots=4, superblock=2, interpret=True)
    tsrv = SolveServer(max_slots=4, superblock=2, torch_device="cpu")
    for srv, first, late in ((jsrv, jreqs, jlate), (tsrv, treqs, tlate)):
        for r in first:
            srv.submit(r)
        srv.step()
        srv.submit(late[0])
        done = srv.drain()
        assert {id(r) for r in done} == {id(r) for r in first + late}
    _agree(jsrv, jreqs + jlate, tsrv, treqs + tlate)


def test_serve_reference_policy_round_trips():
    jsrv, jreqs, tsrv, treqs = _serve([(_problem(12, 12), dict(
        tol=None, max_iters=6, policy="reference", t=3))], max_slots=2,
        superblock=4)
    _agree(jsrv, jreqs, tsrv, treqs)
    want = treqs[0].grid
    for _ in range(6):
        want = TS.apply_stencil(want, TS.jacobi_2d_5pt())
    assert treqs[0].iters_done == 6 and torch.equal(treqs[0].result, want)


def test_nine_point_spec_serves_bit_exact_superblocked():
    jsrv, jreqs, tsrv, treqs = _serve([
        (_problem(16, 16, seed=7), dict(spec="laplace9", tol=1.5e-3,
                                        max_iters=96, policy="rowchunk",
                                        t=8)),
        (_problem(16, 16, seed=7, scale=0.5),
         dict(spec="laplace9", tol=1.5e-3, max_iters=96, policy="rowchunk",
              t=8))], max_slots=4, superblock=4)
    _agree(jsrv, jreqs, tsrv, treqs)


def test_grids_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default serves on it")
    with pytest.raises(RuntimeError, match="cuda"):
        SolveServer()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", ["jacobi5", "laplace9"])
def test_lane_residuals_through_a_sweep_equal_residual(spec, dtype):
    """The superblock's residual path on the card (one sweep into a spare
    buffer, the difference taken in place) is bit for bit ``residual``;
    here the sweep's plain version stands in for K2."""
    spec = (TS.jacobi_2d_5pt() if spec == "jacobi5"
            else TS.laplace_2d_9pt())
    rng = np.random.default_rng(5)
    vs = torch.from_numpy(rng.standard_normal((3, 14, 22)).astype(
        np.float32)).to(dtype)
    key = TSolve.BucketKey(shape=(14, 22), dtype=str(dtype)[6:], spec=spec,
                           policy="temporal", t=8, device=None,
                           torch_device="cpu")
    spare = torch.full_like(vs, float("nan"))
    got = TSolve._residuals(vs, key, spare)
    want = TS.residual(vs, spec)
    assert got.dtype == torch.float32 and got.shape == (3,)
    assert torch.equal(got, want)
    assert torch.equal(TSolve._residuals(vs, key, None), want)


def _staged_traffic(case, seen):
    """Port requests for the result-copy tests: ``batched`` mixes
    tolerances over two slots, ``lone`` takes the bypass, ``iterates``
    streams its iterates beside a batched request."""
    kws = {"batched": [dict(tol=5e-2, max_iters=96),
                       dict(tol=2.5e-2, max_iters=96),
                       dict(tol=None, max_iters=24),
                       dict(tol=4e-2, max_iters=96)],
           "lone": [dict(tol=3e-2, max_iters=96)],
           "iterates": [dict(tol=None, max_iters=32, stream_iterates=True,
                             stream=lambda r, p: seen.append(p)),
                        dict(tol=5e-2, max_iters=96)]}[case]
    return [SolveRequest(grid=grid_from_numpy(
        _problem(16, 16, seed=7, scale=1.0 / (j + 1)), device="cpu"),
        policy="temporal", t=8, **kw) for j, kw in enumerate(kws)]


def _solo(req):
    return TE.run(req.grid, req.spec, policy=req.key.policy,
                  iters=req.iters_done, t=req.key.t)


@pytest.mark.parametrize("case", ["batched", "lone", "iterates"])
def test_a_request_is_done_only_with_its_result_on_the_host(case):
    """Stepped by hand: after every step no request is done without its
    result, and the server is busy exactly while a request is not done
    (queued, in a slot, or its copy pending). Each result is a CPU tensor
    of its own, its solo run bit for bit, copied once through a pool of
    at most ``max_slots`` buffers; ``solve()`` returns the same results
    filled in."""
    staged = TM.counter("serve.result_copy.staged").value
    seen = []
    srv = SolveServer(max_slots=2, superblock=2, torch_device="cpu")
    reqs = [srv.submit(r) for r in _staged_traffic(case, seen)]
    for _ in range(100):
        if not srv.busy:
            break
        srv.step()
        for r in reqs:
            assert not r.done or r.result is not None
        assert srv.busy == (not all(r.done for r in reqs))
    assert not srv.busy
    assert TM.counter("serve.result_copy.staged").value == \
        staged + len(reqs)
    (bucket,) = srv._buckets.values()
    assert 0 < bucket.staging <= srv.max_slots
    assert len(bucket.free) == bucket.staging
    pool = {b.data_ptr() for b in bucket.free}
    for r in reqs:
        assert r.result.device.type == "cpu"
        assert r.result.dtype == r.grid.dtype
        assert r.result.data_ptr() not in pool
        assert torch.equal(r.result, _solo(r))
    again = SolveServer(max_slots=2, superblock=2,
                        torch_device="cpu").solve(_staged_traffic(case, []))
    for a, r in zip(again, reqs):
        assert a.done and torch.equal(a.result, r.result)
    if case == "lone":
        assert srv.stats()["launches"] == 1
    if case == "iterates":
        assert [p.iters_done for p in seen] == [8, 16, 24, 32]
        for p in seen:
            assert p.iterate.data_ptr() not in pool
            assert torch.equal(p.iterate, TE.run(
                reqs[0].grid, reqs[0].spec, policy="temporal",
                iters=p.iters_done, t=8))
        assert len({p.iterate.data_ptr() for p in seen}) == len(seen)


@pytest.mark.parametrize("others", [0, 2])
def test_a_lone_eviction_behind_a_spent_pool_finishes_the_oldest_copy(
        monkeypatch, others):
    """Four lanes evicted in one step hold the whole pool of four while
    their copies have not landed (the copy thread is held back); the lone
    request finishing in the next step first finishes the oldest of them,
    its own bucket's oldest where ``others`` requests of another bucket
    were evicted before them. Every result is still its solo run bit for
    bit, staged once."""
    import threading
    gate = threading.Event()
    host = TSolve._host

    def held(u):
        assert gate.wait(timeout=60)
        return host(u)
    monkeypatch.setattr(TSolve, "_host", held)
    waits = TM.counter("serve.result_copy.pool_waits").value
    staged = TM.counter("serve.result_copy.staged").value
    quick = [SolveRequest(grid=grid_from_numpy(
        _problem(16, 16, seed=s), device="cpu"), tol=tol, max_iters=8,
        policy="temporal", t=8)
        for s, tol in ((1, None), (2, 1e30), (3, None), (4, 1e30))]
    lone = SolveRequest(grid=grid_from_numpy(_problem(16, 16), device="cpu"),
                        tol=3e-3, max_iters=96, policy="temporal", t=8)
    before = [SolveRequest(grid=grid_from_numpy(
        _problem(12, 20, seed=s), device="cpu"), tol=None, max_iters=8,
        policy="temporal", t=8) for s in range(others)]
    srv = SolveServer(max_slots=4, superblock=1, torch_device="cpu")
    for r in before + quick + [lone]:
        srv.submit(r)
    try:
        assert srv.step() == 1 + bool(others)
        assert srv.busy and not any(r.done for r in before + quick)
        assert [r.iters_done for r in quick] == [8] * 4
    finally:
        gate.set()
    srv.drain()
    assert TM.counter("serve.result_copy.pool_waits").value == waits + 1
    assert TM.counter("serve.result_copy.staged").value == \
        staged + 5 + others
    assert lone.iters_done > 8
    assert srv.stats()["launches"] == 2 + bool(others)
    assert srv._buckets[lone.key].staging == 4
    for r in before + quick + [lone]:
        assert r.done and torch.equal(r.result, _solo(r))


def test_results_stay_exact_with_the_copy_thread_switched_often():
    """Twenty-four requests on four slots, the interpreter switching
    threads every microsecond: every result is its solo run bit for bit
    and a tensor of its own, though each staging buffer served many."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reqs = [SolveRequest(grid=grid_from_numpy(
            _problem(16, 16, seed=j), device="cpu"),
            tol=(None, 5e-2, 2e-2, 1e-2)[j % 4], max_iters=8 * (1 + j % 5),
            policy="temporal", t=8) for j in range(24)]
        srv = SolveServer(max_slots=4, superblock=2, torch_device="cpu")
        srv.solve(reqs)
    finally:
        sys.setswitchinterval(interval)
    assert srv._buckets[reqs[0].key].staging <= 4
    assert len({r.result.data_ptr() for r in reqs}) == len(reqs)
    for r in reqs:
        assert r.done and torch.equal(r.result, _solo(r))
