"""The port's Jacobi drivers and paper-facing entry points against the JAX
package's, on the CPU.

Grids are seeded numpy arrays (66 x 130 and an odd width, 66 x 131, with
a hot left side and a uniform interior) handed to both packages; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances are ``tests/test_engine.py:35``'s: f32 1e-6, bf16 2e-2. The
JAX ``policy="reference"`` scan is jitted, and XLA rewrites its tap sum
(ROADMAP Queue 3), so the port's reference is held bit for bit against
the JAX oracle applied op by op, and within tolerance of the JAX driver.
Within the port, each driver is held bit for bit against the engine call
it amounts to.
"""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jacobi as JJ
from repro.core import stencil as JS
from repro.kernels import jacobi as JK
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels import stencil_general as JG
from repro_torch import engine as TE
from repro_torch.core import jacobi as TJ
from repro_torch.core import stencil as TS
from repro_torch.interop import grid_from_numpy, grid_to_numpy
from repro_torch.kernels import jacobi as TK
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import stencil_general as TG

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SHAPES = [(66, 130), (66, 131)]
POLICIES = ["reference", "shifted", "rowchunk", "dbuf", "temporal", "auto"]
ITERS = 11  # one fused block of t = 8 and a 3-sweep remainder


@functools.lru_cache(maxsize=None)
def _grid(shape, seed=0) -> np.ndarray:
    a = np.zeros(shape, np.float32)
    a[:, 0] = 1.0
    a[1:-1, 1:-1] = np.random.default_rng(seed).uniform(
        0, 1, (shape[0] - 2, shape[1] - 2))
    return a


def _pair(shape, dname, seed=0):
    a = _grid(shape, seed)
    jd, td = DTYPES[dname]
    return (jnp.asarray(a).astype(jd),
            grid_from_numpy(a, device="cpu").to(td))


def _close(got, want, dname):
    np.testing.assert_allclose(grid_to_numpy(got.to(torch.float32)),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dname])


def _bits(got, want):
    np.testing.assert_array_equal(grid_to_numpy(got.to(torch.float32)),
                                  np.asarray(want.astype(jnp.float32)))


def _eager_oracle(ju, n, spec=None):
    """The JAX oracle applied op by op (no jit, so no XLA rewrite)."""
    spec = spec or JS.jacobi_2d_5pt()
    for _ in range(n):
        ju = JS.apply_stencil(ju, spec)
    return ju


# ------------------------------ drivers ------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_jacobi_run_matches_the_jax_driver(policy, dname, shape):
    ju, tu = _pair(shape, dname)
    want = JJ.jacobi_run(ju, ITERS, policy=policy, interpret=True)
    got = TJ.jacobi_run(tu, ITERS, policy=policy)
    assert got.dtype == tu.dtype and got.shape == tu.shape
    _close(got, want, dname)
    if policy == "reference":
        _bits(got, _eager_oracle(ju, ITERS))
    else:
        assert torch.equal(got, TE.run(tu, policy=policy, iters=ITERS))


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("step", ["reference", "rowchunk", "callable"])
def test_jacobi_run_unrolled_matches_the_jax_driver(step, dname):
    ju, tu = _pair(SHAPES[0], dname, seed=1)
    if step == "callable":
        jstep = functools.partial(JO.jacobi_step, version="v1db", bm=16,
                                  interpret=True)
        tstep = TO.make_step_fn("v1db")
    else:
        jstep = tstep = step
    want = JJ.jacobi_run_unrolled(ju, 7, jstep, unroll=3)
    got = TJ.jacobi_run_unrolled(tu, 7, tstep, unroll=3)
    _close(got, want, dname)
    looped = TJ.jacobi_run(tu, 7, tstep if step == "callable" else None,
                           policy=None if step == "callable" else step)
    assert torch.equal(got, looped)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("t,iters", [(4, 11), (8, 16), (3, 2)])
def test_jacobi_run_temporal_matches_the_jax_driver(t, iters, legacy, dname):
    """The engine path (K1 blocks and a K2 remainder), and the legacy path
    with a fused ``tstep``; either equals ``engine.run(temporal)``, but for
    the legacy path with fewer sweeps than ``t``, which runs them all
    under the remainder policy (the engine clips ``t`` to ``iters``)."""
    ju, tu = _pair(SHAPES[1], dname, seed=2)
    jk = tk = {}
    if legacy:
        jk = dict(tstep=functools.partial(JO.jacobi_step, version="v2", t=t,
                                          bm=16, interpret=True))
        tk = dict(tstep=TO.make_step_fn("v2", t=t))
    want = JJ.jacobi_run_temporal(ju, iters, t=t, interpret=True, **jk)
    got = TJ.jacobi_run_temporal(tu, iters, t=t, **tk)
    _close(got, want, dname)
    if legacy and iters < t:
        assert torch.equal(got, TE.run(tu, policy="rowchunk", iters=iters))
    else:
        assert torch.equal(got, TE.run(tu, policy="temporal", iters=iters,
                                       t=t))


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("policy,tol,check_every", [
    ("rowchunk", 2e-2, 10), ("auto", 0.11, 25), ("reference", 2e-2, 10),
    ("dbuf", 0.0, 10)])
def test_jacobi_solve_realizes_the_jax_iterations(policy, tol, check_every,
                                                  dname):
    """Equal realized iterations (in steps of ``check_every``, past
    ``max_iters`` when it is not a multiple: 25 -> 30), the result within
    tolerance of the JAX solve and bit for bit ``jacobi_run`` at the
    realized count, the residual its last chunk's flushed update."""
    ju, tu = _pair(SHAPES[0], dname, seed=3)
    max_iters = 25 if tol == 0.0 else 200
    kw = dict(tol=tol, max_iters=max_iters, check_every=check_every,
              policy=policy)
    wu, wn, wr = JJ.jacobi_solve(ju, interpret=True, **kw)
    gu, gn, gr = TJ.jacobi_solve(tu, **kw)
    assert isinstance(gn, int) and gn == int(wn)
    assert gn % check_every == 0
    if tol == 0.0:
        assert gn == 30
    else:
        assert gn < max_iters and gr <= tol < float(
            TE.residual_for()(tu)) and float(wr) <= tol
    _close(gu, wu, dname)
    np.testing.assert_allclose(gr, float(wr), **TOL[dname])
    # "auto" resolves per sweep (engine.step); jacobi_run would hand the
    # whole count to engine.run, which fuses.
    step = (functools.partial(TE.step, policy="auto") if policy == "auto"
            else None)
    name = None if policy == "auto" else policy
    assert torch.equal(gu, TJ.jacobi_run(tu, gn, step, policy=name))
    prev = TJ.jacobi_run(tu, gn - check_every, step, policy=name)
    assert gr == float(TS.max_update(gu, prev, 1))


def test_jacobi_solve_with_a_step_callable_and_a_spec():
    spec = (JS.laplace_2d_9pt(), TS.laplace_2d_9pt())
    ju, tu = _pair(SHAPES[0], "float32", seed=4)
    jstep = functools.partial(JS.apply_stencil, spec=spec[0])
    tstep = functools.partial(TS.apply_stencil, spec=spec[1])
    wu, wn, wr = JJ.jacobi_solve(ju, 3e-2, 300, 20, jstep, spec[0])
    gu, gn, gr = TJ.jacobi_solve(tu, 3e-2, 300, 20, tstep, spec[1])
    assert gn == int(wn) < 300
    _close(gu, wu, "float32")
    assert gr == pytest.approx(float(wr), rel=1e-5)


def test_resolve_step_refuses_as_the_reference_does():
    ju, tu = _pair((18, 34), "float32")
    for J, u in ((JJ, ju), (TJ, tu)):
        with pytest.raises(ValueError, match="not both"):
            J.jacobi_run(u, 3, J.reference_step(), policy="rowchunk")
        with pytest.raises(ValueError, match="not both"):
            J.jacobi_solve(u, step=J.reference_step(), policy="rowchunk")
        with pytest.raises(ValueError, match="not both"):
            J.jacobi_run_unrolled(u, 3, J.reference_step(),
                                  policy="rowchunk")
        with pytest.raises(ValueError, match="is fused"):
            J.jacobi_solve(u, policy="temporal")
        with pytest.raises(ValueError, match="is fused"):
            J.jacobi_run_unrolled(u, 3, "temporal")
    msgs = []
    for J, u in ((JJ, ju), (TJ, tu)):
        with pytest.raises(ValueError) as e:
            J.jacobi_solve(u, policy="temporal")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="unknown policy"):
        TJ.jacobi_run(tu, 3, policy="nope")


# ----------------------- kernels: ops, ref, legacy -----------------------

def test_versions_match_the_reference():
    assert TO.VERSIONS == JO.VERSIONS
    assert TO.VERSION_TO_POLICY == JO.VERSION_TO_POLICY
    assert set(TO.VERSION_TO_POLICY.values()) <= set(TE.available_policies())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("version", ["ref", "v0", "v1", "v1db", "v2"])
def test_jacobi_step_versions(version, dname, shape):
    ju, tu = _pair(shape, dname, seed=5)
    want = JO.jacobi_step(ju, version=version, bm=16, t=4, interpret=True)
    got = TO.jacobi_step(tu, version=version, t=4)
    _close(got, want, dname)
    if version == "ref":
        _bits(got, _eager_oracle(ju, 1))
    else:
        policy = TO.VERSION_TO_POLICY[version]
        kw = dict(t=4) if policy == "temporal" else {}
        assert torch.equal(got, getattr(TE, f"stencil_{policy}")(
            tu, TS.jacobi_2d_5pt(), **kw))
    with pytest.raises(ValueError, match="unknown jacobi kernel version"):
        TO.jacobi_step(tu, version="v3")


LEGACY = [("jacobi_v0_shifted", "shifted"), ("jacobi_v1_rowchunk", "rowchunk"),
          ("jacobi_v1_dbuf", "dbuf"), ("jacobi_v2_temporal", "temporal")]


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name,policy", LEGACY)
def test_deprecated_wrappers(name, policy, dname):
    """Each warns, equals the JAX wrapper within tolerance and the port's
    ``engine.stencil_*`` bit for bit."""
    ju, tu = _pair(SHAPES[1], dname, seed=6)
    with pytest.warns(DeprecationWarning, match=name):
        want = getattr(JK, name)(ju, bm=16, interpret=True)
    with pytest.warns(DeprecationWarning,
                      match=f"repro_torch.kernels.jacobi.{name}"):
        got = getattr(TK, name)(tu)
    _close(got, want, dname)
    spec = TS.jacobi_2d_5pt()
    assert torch.equal(got, getattr(TE, f"stencil_{policy}")(tu, spec))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_deprecated_general_rowchunk(dname):
    spec = (JS.laplace_2d_9pt(), TS.laplace_2d_9pt())
    ju, tu = _pair(SHAPES[1], dname, seed=7)
    with pytest.warns(DeprecationWarning):
        want = JG.stencil_rowchunk(ju, spec[0], bm=16, interpret=True)
    with pytest.warns(DeprecationWarning, match="stencil_general"):
        got = TG.stencil_rowchunk(tu, spec[1])
    _close(got, want, dname)
    assert torch.equal(got, TE.stencil_rowchunk(tu, spec[1]))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_ref_oracles_match_the_reference(dname):
    ju, tu = _pair(SHAPES[0], dname, seed=8)
    _bits(TR.jacobi_step(tu), JR.jacobi_step(ju))
    _bits(TR.jacobi_multi(tu, 5), JR.jacobi_multi(ju, 5))
    spec = (JS.advection_2d_3pt(), TS.advection_2d_3pt())
    _bits(TR.stencil_step(tu, spec[1]), JR.stencil_step(ju, spec[0]))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 40, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jd, td = DTYPES[dname]
    for bias in (None, b):
        want = JR.conv1d_depthwise_causal(
            jnp.asarray(x, jd), jnp.asarray(w, jd),
            None if bias is None else jnp.asarray(bias, jd))
        got = TR.conv1d_depthwise_causal(
            torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
            None if bias is None else torch.from_numpy(bias).to(td))
        _bits(got, want)
    xs = rng.standard_normal((16, 32)).astype(np.float32)
    tx = torch.from_numpy(xs).to(td)
    assert TR.stream_copy(tx) is tx
    for factor in (1, 3, 32):
        _bits(TR.stream_replicated(tx, factor),
              JR.stream_replicated(jnp.asarray(xs, jd), factor))
    ints = rng.integers(-1000, 1000, (8, 16)).astype(np.int32)
    got = TR.stream_replicated(torch.from_numpy(ints), 7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JR.stream_replicated(jnp.asarray(ints), 7)))


# ------------------------------ entry points ------------------------------

def test_jacobi2d_config_matches_the_reference():
    import dataclasses
    from repro.configs import jacobi2d as JC
    from repro_torch.configs import jacobi2d as TC
    for get in ("config", "smoke"):
        assert dataclasses.asdict(getattr(TC, get)()) == \
            dataclasses.asdict(getattr(JC, get)())


def _cli(capsys, *args):
    from repro_torch.launch import solve
    solve.main(["--ny", "30", "--nx", "62", "--device", "cpu", "--check",
                *args])
    return capsys.readouterr().out


@pytest.mark.parametrize("kernel,schedule", [
    ("ref", "reference: 19 sweeps = 19 x t=1"),
    ("v0", "shifted: 19 sweeps = 19 x t=1"),
    ("v1", "rowchunk: 19 sweeps = 19 x t=1"),
    ("v1db", "dbuf: 19 sweeps = 19 x t=1"),
    ("v2", "temporal: 19 sweeps = 4 x t=4 + 3 (rowchunk)")])
def test_cli_legacy_tags(capsys, kernel, schedule):
    out = _cli(capsys, "--iters", "19", "--kernel", kernel, "--temporal", "4")
    assert f"schedule: {schedule}" in out
    assert f"kernel={kernel} " in out and "CHECK OK" in out


def test_cli_t_overrides_temporal(capsys):
    out = _cli(capsys, "--iters", "19", "--kernel", "v2", "--temporal", "4",
               "--t", "8", "--dtype", "bfloat16")
    assert "temporal: 19 sweeps = 2 x t=8 + 3 (rowchunk)" in out
    assert "CHECK OK" in out
    out = _cli(capsys, "--iters", "19", "--kernel", "v2", "--temporal", "8",
               "--tol", "1e-3")
    assert "iters=16/19" in out and "CHECK OK" in out


def test_cli_ref_steps_the_oracle(capsys):
    """``ref`` steps the plain oracle (bit for bit the JAX one applied op
    by op) through ``jacobi_run``."""
    out = _cli(capsys, "--iters", "7", "--kernel", "ref")
    u0 = TS.make_laplace_problem(30, 62, left=1.0, right=0.0, device="cpu")
    want = TJ.jacobi_run(u0, 7)
    _bits(want, _eager_oracle(JS.make_laplace_problem(30, 62, left=1.0,
                                                      right=0.0), 7))
    assert f"mean={float(want[1:-1, 1:-1].mean()):.6f}" in out


def test_example_quickstart(capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "detected device model: cpu_ref" in out
    assert "converged in ~" in out and "(MODELED)" in out
    # The solve realizes the JAX quickstart's count.
    u0 = JS.make_laplace_problem(128, 128, left=1.0, right=0.0)
    _, n, _ = JJ.jacobi_solve(u0, tol=1e-5, check_every=200,
                              policy="rowchunk", interpret=True)
    assert f"converged in ~{int(n)} sweeps" in out


def test_example_distributed_jacobi(capsys):
    from repro_torch.examples import distributed_jacobi
    distributed_jacobi.main(["--device", "cpu", "--ny", "64", "--nx", "128",
                             "--iters", "9"])
    out = capsys.readouterr().out
    assert out.count("max|err|=0.00e+00") == 6
    assert "8 shards (4, 2) on cpu t=4" in out and "exchanges=  3" in out


def test_example_serve_lm(capsys):
    from repro_torch.examples import serve_lm
    serve_lm.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and lines[0].startswith("req0 (greedy): [")
    assert all(len(json.loads(x.split(": ", 1)[1])) == 16 for x in lines)


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    from repro_torch.examples import quickstart
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])
