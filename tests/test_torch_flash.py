"""K8 on the CPU: the port's plain flash attention against the JAX kernel.

The JAX side runs ``flash_attention_local`` in interpret mode; the port's
wrapper runs its plain version on CPU tensors. Inputs are made once with
numpy and handed to both. Tolerances are the JAX package's own
(``tests/test_kernels_flash.py``): f32 2e-5, bf16 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_local as jax_flash
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops as TOPS

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# The JAX package's test shapes, then head dims 112 (zamba2-7b: causal,
# G = 1, and a GQA group of 2) and 80 (hubert-xlarge: non-causal).
SHAPES = [(2, 128, 4, 2, 32, True), (1, 256, 8, 8, 16, True),
          (2, 128, 4, 1, 32, False), (1, 64, 2, 2, 64, True),
          (1, 128, 4, 4, 112, True), (1, 128, 4, 2, 112, False),
          (2, 128, 4, 4, 80, False), (1, 64, 4, 2, 80, True)]


def _inputs(b, s, h, kh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), dtype=np.float32),
            rng.standard_normal((b, s, kh, hd), dtype=np.float32),
            rng.standard_normal((b, s, kh, hd), dtype=np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kh,hd,causal", SHAPES)
def test_plain_matches_jax_kernel(b, s, h, kh, hd, causal, dname):
    jdt, tdt = DTYPES[dname]
    qkv = _inputs(b, s, h, kh, hd)
    want = jax_flash(*(jnp.asarray(a, jdt) for a in qkv), causal=causal,
                     bq=64, bk=64, interpret=True)
    before = TF.LAUNCHES["flash_attention"]
    got = TF.flash_attention_local(*(_torch(a, tdt) for a in qkv),
                                   causal=causal, bq=64, bk=64)
    assert TF.LAUNCHES["flash_attention"] == before  # plain: no launch
    assert got.dtype == tdt and got.shape == (b, s, h, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dname], atol=TOL[dname])


def test_block_shape_independence():
    qkv = [_torch(a, torch.float32) for a in _inputs(1, 128, 4, 2, 32, 1)]
    a = TF.flash_attention_local(*qkv, bq=32, bk=64)
    c = TF.flash_attention_local(*qkv, bq=128, bk=16)
    np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-5, atol=2e-5)


def test_ops_wrapper_is_the_local_kernel_and_default_blocks():
    qkv = [_torch(a, torch.float32) for a in _inputs(2, 128, 4, 2, 32, 2)]
    want = jax_flash(*(jnp.asarray(t.numpy()) for t in qkv), causal=True,
                     interpret=True)
    got = TOPS.flash_attention(*qkv, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("bq,bk,s", [(48, 64, 128), (64, 48, 128),
                                     (512, 512, 600)])
def test_indivisible_blocks_raise(bq, bk, s):
    qkv = [_torch(a, torch.float32) for a in _inputs(1, s, 2, 1, 16)]
    with pytest.raises(ValueError, match="sq % bq"):
        TF.flash_attention_local(*qkv, bq=bq, bk=bk)


def test_bad_shapes_raise():
    q, k, v = (_torch(a, torch.float32) for a in _inputs(1, 64, 3, 2, 16))
    with pytest.raises(ValueError, match="multiple of K"):
        TF.flash_attention_local(q, k, v)
    with pytest.raises(ValueError, match="one shape"):
        TF.flash_attention_local(q[:, :, :2], k, v[:, :32])


def _tensor_core_rounding(q, k, v, causal, split=True, tile=128):
    """The bf16 tensor-core kernel's arithmetic, written out on the CPU: S
    = Q K^T of the bf16 values summed in f32, scaled by hd**-0.5 after the
    product; an online softmax over 128-key tiles in order (running max
    from -1e30, masked scores -1e30, the sum l of the f32 P); P split into
    its bf16 rounding and the bf16 rounding of the rest, P_hi V + P_lo V
    with f32 sums; acc / max(l, 1e-30) rounded once to bf16. With
    ``split=False`` P V takes P_hi alone."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, s, kh, g, hd).permute(0, 2, 1, 3, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    pos = torch.arange(s)
    m = torch.full((b, kh, s, g), TF.NEG_INF)
    lsum = torch.zeros((b, kh, s, g))
    acc = torch.zeros((b, kh, s, g, hd))
    for k0 in range(0, s, tile):
        sc = torch.einsum("bkqgd,bksd->bkqgs", qf,
                          kf[:, :, k0:k0 + tile]) * hd ** -0.5
        if causal:
            keep = pos[k0:k0 + tile][None, :] <= pos[:, None]
            sc = torch.where(keep[:, None, :], sc, TF.NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        lsum = lsum * alpha + p.sum(dim=-1)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float() if split else 0 * p
        vb = vf[:, :, k0:k0 + tile]
        acc = (acc * alpha[..., None]
               + torch.einsum("bkqgs,bksd->bkqgd", p_hi, vb)
               + torch.einsum("bkqgs,bksd->bkqgd", p_lo, vb))
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.to(torch.bfloat16).permute(0, 2, 1, 3, 4).reshape(b, s, h, hd)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_rounding_within_the_bf16_bound(causal, split):
    """The bf16 kernel's roundings (P as two bf16 halves, or P_hi alone,
    the scale after an f32 Q K^T, 128-key tiles) stay within the bf16
    gate, rtol = atol = 3e-2, of both the JAX kernel (interpret mode) and
    the port's plain version, at hd 128, a GQA group of 8 and S 512."""
    qkv = _inputs(1, 512, 16, 2, 128, seed=3)
    got = _tensor_core_rounding(*(_torch(a, torch.bfloat16) for a in qkv),
                                causal, split)
    jax_out = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in qkv),
                        causal=causal, interpret=True)
    plain = TF.flash_attention_local_plain(
        *(_torch(a, torch.bfloat16) for a in qkv), causal=causal)
    for want in (np.asarray(jax_out, np.float32), plain.float().numpy()):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                                   atol=3e-2)


def _split_tf32(x):
    """The f32 kernel's split of an f32 tensor: ``big``, x rounded to TF32
    (the low 13 mantissa bits dropped, rounding to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``), and ``small``, the exact rest
    ``x - big`` rounded the same way."""
    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    big = tf32(x.to(torch.float32))
    return big, tf32(x - big)


def _split_tf32_rounding(q, k, v, causal):
    """The f32 kernel's arithmetic, written out on the CPU: q scaled by
    hd**-0.5 in f32; every operand of Q K^T and P V split into its TF32
    rounding (big) and the TF32 rounding of the rest (small), each product
    formed as small*big + big*small + big*big with f32 sums; an online
    softmax over tiles of 32 keys in order, running max from -1e30, causal
    scores -1e30, the sum l of the f32 P; acc / max(l, 1e-30)."""
    b, s, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    tile = 32
    qs = (q * hd ** -0.5).reshape(b, s, kh, g, hd).permute(0, 2, 1, 3, 4)
    kf, vf = (x.permute(0, 2, 1, 3) for x in (k, v))
    (qb, qsm), (kb, ksm), (vb, vsm) = (_split_tf32(x) for x in (qs, kf, vf))

    def prod(eq, a_big, a_small, b_big, b_small):
        return (torch.einsum(eq, a_small, b_big)
                + torch.einsum(eq, a_big, b_small)
                + torch.einsum(eq, a_big, b_big))

    pos = torch.arange(s)
    m = torch.full((b, kh, s, g), TF.NEG_INF)
    lsum = torch.zeros((b, kh, s, g))
    acc = torch.zeros((b, kh, s, g, hd))
    for k0 in range(0, sk, tile):
        keys = slice(k0, k0 + tile)
        sc = prod("bkqgd,bksd->bkqgs", qb, qsm, kb[:, :, keys],
                  ksm[:, :, keys])
        if causal:
            keep = pos[keys][None, :] <= pos[:, None]
            sc = torch.where(keep[:, None, :], sc, TF.NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        lsum = lsum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + prod(
            "bkqgs,bksd->bkqgd", *_split_tf32(p), vb[:, :, keys],
            vsm[:, :, keys])
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, h, hd)


# The f32 cases of chip_smoke.py's FLASH_SHAPES that run in seconds on the
# CPU (all but the S = 2048 serving shapes, which run on the card): GQA
# groups 1-8, 3 and 5, hd 16 to 256 with 80 and 112, lengths 130 and 300
# that are not a multiple of the key tile, causal and not.
SPLIT_SHAPES = [(2, 128, 4, 2, 32, True), (1, 256, 8, 8, 16, True),
                (2, 128, 4, 1, 32, False), (1, 64, 2, 2, 64, True),
                (1, 192, 6, 2, 128, True), (2, 96, 3, 3, 256, True),
                (1, 128, 12, 4, 64, True), (2, 300, 16, 2, 128, True),
                (1, 130, 5, 1, 32, False), (2, 300, 32, 32, 112, True),
                (1, 256, 8, 4, 112, True), (1, 300, 6, 3, 80, True),
                (1, 256, 4, 4, 80, False)]


@pytest.mark.parametrize("b,s,h,kh,hd,causal", SPLIT_SHAPES)
def test_split_tf32_within_the_f32_bound(b, s, h, kh, hd, causal):
    """The f32 kernel's split-TF32 products and 32-key tiles stay within
    the f32 gate, rtol = atol = 2e-5, of the port's plain version (the TPU
    kernel's tile loop in f32)."""
    q, k, v = (_torch(a, torch.float32)
               for a in _inputs(b, s, h, kh, hd, seed=s + h))
    got = _split_tf32_rounding(q, k, v, causal)
    want = TF.flash_attention_local_plain(q, k, v, causal=causal, bq=s,
                                          bk=s)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_split_tf32_is_the_kernels_rounding():
    """big keeps 11 significant bits, rounded to nearest with ties away
    from zero; small is the exact rest rounded the same way, so big +
    small is within 2^-22 of x."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -12,
                      1 + 2 ** -12 - 2 ** -23, 3.0, -0.1])
    big, small = _split_tf32(x)
    assert big.tolist()[:4] == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -10,
                                1.0]
    assert big[4] == 3.0 and small[4] == 0.0
    assert torch.all(big.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(small.view(torch.int32) & 0x1FFF == 0)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000, dtype=np.float32))
    big, small = _split_tf32(y)
    assert torch.equal(y - big, (y.double() - big.double()).float())
    assert float(((y - big - small).abs() / y.abs()).max()) <= 2 ** -22
