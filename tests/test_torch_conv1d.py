"""The port's depthwise causal conv1d (K7's plain version) against the JAX
package on the CPU.

Inputs are made with numpy and handed to both packages; the JAX side runs
its oracle (``repro.kernels.ref``) and its Pallas kernel in interpret
mode (``repro.kernels.ops.conv1d``). Tolerances are the JAX package's
(``tests/test_kernels_conv1d.py``): f32 ``rtol=atol=1e-5``, bf16
``rtol=atol=3e-2``. The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import conv1d as TK
from repro_torch.kernels import ops as tops

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SHAPES = [(1, 64, 128, 4), (2, 128, 256, 4), (3, 96, 128, 3),
          (1, 32, 384, 2)]


def _inputs(b, l, d, k, dname, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((b, l, d), dtype=np.float32),
            rng.standard_normal((k, d), dtype=np.float32) * 0.5,
            rng.standard_normal((d,), dtype=np.float32))
    jdt, tdt = DT[dname]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, dname):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dname])


@pytest.mark.parametrize("dname", list(DT))
@pytest.mark.parametrize("b,l,d,k", SHAPES)
def test_plain_matches_jax_oracle_and_pallas_kernel(b, l, d, k, dname):
    (jx, jw, jb), (tx, tw, tb) = _inputs(b, l, d, k, dname)
    got = tops.conv1d(tx, tw, tb, bl=32)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jref.conv1d_depthwise_causal(jx, jw, jb), dname)
    _close(got, jops.conv1d(jx, jw, jb, bl=32, interpret=True), dname)
    assert torch.equal(got, tops.conv1d(tx, tw, tb, use_kernel=False))


def test_no_bias_and_causality():
    (jx, jw, _), (tx, tw, _) = _inputs(1, 64, 128, 4, "float32", seed=1)
    got = TK.conv1d_depthwise_causal(tx, tw, None, bl=16)
    _close(got, jref.conv1d_depthwise_causal(jx, jw, None), "float32")
    _close(got, jops.conv1d(jx, jw, None, bl=16, interpret=True), "float32")
    cut = tx.clone()
    cut[:, 32:] = 0.0
    again = TK.conv1d_depthwise_causal(cut, tw, None, bl=16)
    assert torch.equal(again[:, :32], got[:, :32])


@pytest.mark.parametrize("bl", [1, 7, 16, 512])
def test_bl_does_not_change_the_result(bl):
    _, (tx, tw, tb) = _inputs(2, 48, 64, 4, "bfloat16", seed=2)
    assert torch.equal(TK.conv1d_depthwise_causal(tx, tw, tb, bl=bl),
                       TK.conv1d_depthwise_causal_plain(tx, tw, tb))


@pytest.mark.parametrize("length,bl,want", [(2048, 512, 512), (96, 32, 32),
                                            (96, 64, 48), (7, 512, 7),
                                            (13, 4, 1)])
def test_pick_bl_is_the_references_rule(length, bl, want):
    assert TK._pick_bl(length, bl) == want


def test_a_cpu_tensor_counts_no_launch():
    _, (tx, tw, tb) = _inputs(1, 32, 64, 4, "float32")
    TK.reset_launch_counts()
    TK.conv1d_depthwise_causal(tx, tw, tb)
    tops.conv1d(tx, tw, tb)
    assert TK.LAUNCHES == {"conv1d": 0}


@pytest.mark.parametrize("case,err,match", [
    ("f16", TypeError, "float32 or bfloat16"),
    ("mixed", TypeError, "one dtype"),
    ("k9", ValueError, "widths K of 1 to 8"),
    ("w_width", ValueError, r"x \(B, L, D\) and w \(K, D\)"),
    ("x_2d", ValueError, r"x \(B, L, D\) and w \(K, D\)"),
    ("bias", ValueError, r"b must be \(D,\)"),
    ("empty", ValueError, "empty x"),
    ("bl0", ValueError, "bl must be positive"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, err, match):
    _, (x, w, b) = _inputs(1, 16, 32, 4, "float32")
    kw = {}
    if case == "f16":
        x, w, b = x.half(), w.half(), b.half()
    elif case == "mixed":
        w = w.bfloat16()
    elif case == "k9":
        w = torch.zeros((9, 32))
    elif case == "w_width":
        w = w[:, :16]
    elif case == "x_2d":
        x = x[0]
    elif case == "bias":
        b = b[:8]
    elif case == "empty":
        x = x[:, :0]
    elif case == "bl0":
        kw = {"bl": 0}
    with pytest.raises(err, match=match):
        TK.conv1d_depthwise_causal(x, w, b, **kw)
