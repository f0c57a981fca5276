"""The port's oracle against the JAX package's, bit for bit.

Inputs come from numpy and go to both packages; bf16 grids cross as f32
(exact) and are narrowed on each side, so both start from the same bits.
"""
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
