"""The port's oracle against the JAX package's, bit for bit.

Inputs come from numpy and go to both packages; bf16 grids cross as f32
(exact) and are narrowed on each side, so both start from the same bits.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencil as J
from repro_torch.core import stencil as T
from repro_torch.interop import grid_from_numpy, grid_to_numpy, spec_from_fields

SPECS = {
    "jacobi5": (J.jacobi_2d_5pt(), T.jacobi_2d_5pt()),
    "laplace9": (J.laplace_2d_9pt(), T.laplace_2d_9pt()),
    "advection2d": (J.advection_2d_3pt(), T.advection_2d_3pt()),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, dtype_name, seed=0):
    a = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(a).astype(jd), grid_from_numpy(a, device="cpu").to(td)


def _bits_equal(ju, tu):
    np.testing.assert_array_equal(np.asarray(ju.astype(jnp.float32)),
                                  grid_to_numpy(tu.to(torch.float32)))


def test_spec_builders_match_reference():
    for name, (js, ts) in SPECS.items():
        assert ts.offsets == js.offsets and ts.weights == js.weights, name
        assert (ts.radius, ts.taps, ts.ndim) == (js.radius, js.taps, js.ndim)
    j1, t1 = J.advection_1d_3pt(0.3), T.advection_1d_3pt(0.3)
    assert (t1.offsets, t1.weights) == (j1.offsets, j1.weights)
    assert spec_from_fields(J.laplace_2d_9pt()) == T.laplace_2d_9pt()


@pytest.mark.parametrize("sweeps", [1, 7])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_oracle_bitwise(spec_name, dtype, sweeps):
    """Bitwise: the port's apply_stencil equals the JAX oracle."""
    js, ts = SPECS[spec_name]
    ju, tu = _pair((34, 66), dtype, seed=sweeps)
    for _ in range(sweeps):
        ju = J.apply_stencil(ju, js)
        tu = T.apply_stencil(tu, ts)
    assert tu.dtype == DTYPES[dtype][1]
    _bits_equal(ju, tu)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_residual_bitwise(dtype):
    js, ts = SPECS["laplace9"]
    ju, tu = _pair((34, 66), dtype, seed=3)
    want = float(J.residual(ju, js))
    got = T.residual(tu, ts)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == want


def test_residual_is_per_lane_on_a_batch():
    ts = T.jacobi_2d_5pt()
    _, a = _pair((18, 34), "float32", seed=1)
    _, b = _pair((18, 34), "float32", seed=2)
    got = T.residual(torch.stack([a, b]), ts)
    assert got.tolist() == [float(T.residual(a, ts)), float(T.residual(b, ts))]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_make_laplace_problem_matches_reference(dtype):
    jd, td = DTYPES[dtype]
    kw = dict(left=1.0, right=0.5, top=0.25, bottom=0.125, init=0.75)
    want = J.make_laplace_problem(6, 9, dtype=jd, **kw)
    got = T.make_laplace_problem(6, 9, dtype=td, device="cpu", **kw)
    assert tuple(got.shape) == (8, 11) and got.dtype == td
    _bits_equal(want, got)


def test_make_laplace_problem_defaults_to_cuda():
    if torch.cuda.is_available():
        assert T.make_laplace_problem(4, 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            T.make_laplace_problem(4, 4)


def test_interop_bf16_crosses_bit_exact():
    """A JAX bf16 grid reaches numpy as ml_dtypes; the port keeps its bits."""
    ju, _ = _pair((10, 12), "bfloat16", seed=5)
    arr = np.asarray(ju)
    assert arr.dtype.name == "bfloat16"
    tu = grid_from_numpy(arr, device="cpu")
    assert tu.dtype == torch.bfloat16
    _bits_equal(ju, tu)
    back = grid_to_numpy(tu)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, arr.astype(np.float32))


def test_interior_and_small_grid_error():
    u = torch.arange(30.0).reshape(5, 6)
    assert T.interior(u, 1).shape == (3, 4)
    with pytest.raises(ValueError, match="too small"):
        T.apply_stencil(torch.zeros(2, 6), T.jacobi_2d_5pt())


# ---------------------------------------------------------------------------
# Subnormals: a diffusion front's tail, flushed as XLA flushes it
# ---------------------------------------------------------------------------

POLICIES = ("reference", "rowchunk", "dbuf", "shifted", "temporal")
TINY = np.finfo(np.float32).tiny


@functools.lru_cache(maxsize=None)
def _laplace_start(dtype: str) -> np.ndarray:
    """The front that goes subnormal: 62 x 258 interior, left side 1."""
    return np.asarray(J.make_laplace_problem(
        62, 258, dtype=DTYPES[dtype][0], left=1.0).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _eager_oracle(spec_name: str, dtype: str, sweeps: int) -> np.ndarray:
    """The JAX oracle applied op by op: every multiply and add is its own
    XLA computation, flushed as XLA flushes (no jit rewrites)."""
    js, _ = SPECS[spec_name]
    u = jnp.asarray(_laplace_start(dtype)).astype(DTYPES[dtype][0])
    for _ in range(sweeps):
        u = J.apply_stencil(u, js)
    return np.asarray(u.astype(jnp.float32))


def _port_run(spec_name, dtype, policy, sweeps, device="cpu_ref"):
    from repro_torch import engine as TE
    _, ts = SPECS[spec_name]
    u = grid_from_numpy(_laplace_start(dtype), device="cpu").to(
        DTYPES[dtype][1])
    t = 8 if policy == "temporal" else None
    out = TE.run(u, ts, policy=policy, iters=sweeps, t=t, device=device)
    return grid_to_numpy(out.to(torch.float32))


def _subnormals(a: np.ndarray) -> int:
    return int(((a != 0) & (np.abs(a) < TINY)).sum())


@pytest.mark.parametrize("sweeps", [200, 1000])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_subnormal_tail_f32_bitwise(spec_name, sweeps):
    """From ~60 sweeps on, the front's tail is subnormal: every policy of
    the port flushes it as the JAX oracle's XLA arithmetic does, bit for
    bit, and keeps no subnormal cell."""
    want = _eager_oracle(spec_name, "float32", sweeps)
    for policy in POLICIES:
        got = _port_run(spec_name, "float32", policy, sweeps)
        np.testing.assert_array_equal(got, want, err_msg=policy)
        assert _subnormals(got) == 0, policy


@pytest.mark.parametrize("spec_name", list(SPECS))
def test_subnormal_tail_bf16(spec_name):
    """bf16: the one-sweep policies equal the oracle bit for bit; the
    fused temporal policy rounds once a block, as the JAX one does, and
    stays within the reference tests' bf16 tolerance of it. Neither
    package keeps a subnormal cell."""
    from repro import engine as JE
    js, _ = SPECS[spec_name]
    want = _eager_oracle(spec_name, "bfloat16", 200)
    for policy in POLICIES[:-1]:
        got = _port_run(spec_name, "bfloat16", policy, 200)
        np.testing.assert_array_equal(got, want, err_msg=policy)
        assert _subnormals(got) == 0, policy
    ju = jnp.asarray(_laplace_start("bfloat16")).astype(jnp.bfloat16)
    jt = np.asarray(JE.run(ju, js, policy="temporal", iters=200, t=8,
                           device="cpu_ref").astype(jnp.float32))
    got = _port_run(spec_name, "bfloat16", "temporal", 200)
    assert _subnormals(got) == _subnormals(jt) == 0
    np.testing.assert_allclose(got, jt, rtol=2e-2, atol=2e-2)


def _factored_jacobi(u: np.ndarray, sweeps: int) -> np.ndarray:
    """jacobi5 as XLA's algebraic simplifier rewrites the jitted tap sum
    (one weight for all taps: ``(Σ c) · 0.25``), flushed every op."""
    def ftz(a):
        return np.where(np.abs(a) < TINY, np.float32(0), a)
    h, w = u.shape
    for _ in range(sweeps):
        c = ftz(u)
        s = None
        for dy, dx in J.jacobi_2d_5pt().offsets:
            tap = c[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
            s = tap if s is None else ftz(s + tap)
        u = u.copy()
        u[1:-1, 1:-1] = ftz(s * np.float32(0.25))
    return u


@pytest.mark.parametrize("sweeps", [200, 1000])
def test_jitted_reference_differs_only_by_its_own_rewrite(sweeps):
    """The JAX ``engine.run`` is jitted, and XLA may rewrite jacobi5's tap
    sum as ``(Σ c) · 0.25``, which differs from the oracle's sum of
    products only once the tail is subnormal. Its result is either the
    oracle's or that rewrite's, bit for bit; the port's is the oracle's,
    and any difference from the JAX engine lies in the front's far tail
    (below 2**-80), where the two flush at different cells."""
    from repro import engine as JE
    ju = jnp.asarray(_laplace_start("float32"))
    jrun = np.asarray(JE.run(ju, J.jacobi_2d_5pt(), policy="reference",
                             iters=sweeps, device="cpu_ref"))
    eager = _eager_oracle("jacobi5", "float32", sweeps)
    assert (np.array_equal(jrun, eager) or np.array_equal(
        jrun, _factored_jacobi(_laplace_start("float32"), sweeps)))
    got = _port_run("jacobi5", "float32", "reference", sweeps)
    np.testing.assert_array_equal(got, eager)
    assert np.all(np.abs(jrun[got != jrun]) < 2.0 ** -80)


@pytest.mark.parametrize("policy", ["rowchunk", "temporal"])
def test_simulator_keeps_the_references_own_gap(policy):
    """The JAX simulator flushes only the finished tap sum, so at 200
    sweeps it differs from the JAX engine in a few tail cells (14 under
    jax 0.9.0). The port's simulator reproduces the JAX simulator bit for
    bit, that gap included."""
    from repro import backends as JB
    from repro import engine as JE
    from repro_torch import backends as TB
    js, ts = SPECS["jacobi5"]
    start = _laplace_start("float32")
    kw = dict(policy=policy, iters=200, t=8, device="grayskull_e150")
    jsim = np.asarray(JB.simulate(jnp.asarray(start), js, **kw).grid)
    jrun = np.asarray(JE.run(jnp.asarray(start), js, **kw))
    tsim = TB.simulate(grid_from_numpy(start, device="cpu"), ts,
                       **kw).grid.numpy()
    np.testing.assert_array_equal(tsim, jsim)
    np.testing.assert_array_equal(tsim != jrun, jsim != jrun)


def _boundary_products(n: int = 6):
    """(c, w) f32 pairs whose exact product lies just below the smallest
    normal: half of them more than half a unit (2**-150) below, which XLA
    flushes although f32 rounding gives the smallest normal, half within
    it, which XLA keeps."""
    rng = np.random.default_rng(5)
    below, within = [], []
    for w in rng.uniform(0.01, 0.99, 2000).astype(np.float32):
        base = np.float32(TINY / float(w)).view(np.uint32)
        for c in (base + np.arange(-3, 4)).astype(np.uint32).view(
                np.float32):
            e = (float(c) * float(w) - float(TINY)) / 2.0 ** -150
            if -1 < e < -0.5 and len(below) < n:
                below.append((c, w))
            elif -0.5 < e < 0 and len(within) < n:
                within.append((c, w))
    return below + within


@pytest.mark.parametrize("c,w", _boundary_products())
def test_products_at_the_flush_boundary_match_xla(c, w):
    """A product that f32 rounding lifts to the smallest normal flushes as
    XLA flushes it (and the card: ``chip_smoke.py`` phase 3)."""
    js = J.StencilSpec(((0, 0), (0, 1)), (float(w), 0.25))
    ts = T.StencilSpec(((0, 0), (0, 1)), (float(w), 0.25))
    a = np.zeros((4, 6), np.float32)
    a[:, 1::2] = c
    want = J.apply_stencil(jnp.asarray(a), js)
    got = T.apply_stencil(torch.from_numpy(a), ts)
    _bits_equal(want, got)
    # f32 rounding alone lifts every one of them to the smallest normal.
    assert np.float32(c) * np.float32(w) == TINY


# ---------------------------------------------------------------------------
# The residual flushes as XLA does
# ---------------------------------------------------------------------------

def _subnormal_update_grid() -> np.ndarray:
    """34 x 66, every cell 1e-37 (normal), one interior cell raised by
    5e-39: every update a sweep makes is subnormal, so XLA's residual is
    0."""
    a = np.full((34, 66), 1e-37, np.float32)
    a[10, 20] += np.float32(5e-39)
    return a


def test_residual_flushes_a_subnormal_update():
    a = _subnormal_update_grid()
    js, ts = SPECS["jacobi5"]
    assert float(J.residual(jnp.asarray(a), js)) == 0.0
    assert float(T.residual(torch.from_numpy(a), ts)) == 0.0
    # Without the flush the update is the raised cell's 5e-39.
    v = T.apply_stencil(torch.from_numpy(a), ts)
    raw = float((v - torch.from_numpy(a)).abs().max())
    assert 0.0 < raw < TINY


def test_run_converged_stops_where_the_reference_stops():
    """tol=0: the first block's residual is 0 in both packages, so both
    stop after one block of t = 8 sweeps (the port ran to max_iters)."""
    from repro import engine as JE
    from repro_torch import engine as TE
    a = _subnormal_update_grid()
    js, ts = SPECS["jacobi5"]
    kw = dict(tol=0.0, max_iters=64, policy="rowchunk", t=8,
              device="cpu_ref")
    _, jn, jr = JE.run_converged(jnp.asarray(a), js, interpret=True, **kw)
    tu, tn, tr = TE.run_converged(torch.from_numpy(a), ts, **kw)
    assert (tn, tr) == (int(jn), float(jr)) == (8, 0.0)
    assert torch.equal(tu, TE.run(torch.from_numpy(a), ts, policy="rowchunk",
                                  iters=8, device="cpu_ref"))


def test_served_residual_flushes_like_the_reference_server():
    """One SolveServer request on the grid above realizes the JAX
    server's iterations; the card's residual path (a sweep into a spare
    buffer, here K2's plain version) flushes the same way."""
    from repro.serve import SolveRequest as JRequest
    from repro.serve import SolveServer as JServer
    from repro_torch.serve import SolveRequest, SolveServer
    from repro_torch.serve import solve as TSolve
    a = _subnormal_update_grid()
    kw = dict(tol=0.0, max_iters=64, t=8)
    jreq, treq = JRequest(grid=jnp.asarray(a), **kw), SolveRequest(
        grid=torch.from_numpy(a), **kw)
    JServer(interpret=True).solve([jreq])
    SolveServer(torch_device="cpu").solve([treq])
    assert (treq.iters_done, treq.converged) == (jreq.iters_done,
                                                 jreq.converged) == (8, True)
    assert treq.residual == float(jreq.residual) == 0.0
    key = treq.key
    vs = torch.from_numpy(np.stack([a, a]))
    got = TSolve._residuals(vs, key, torch.full_like(vs, float("nan")))
    assert got.tolist() == [0.0, 0.0]
