"""GQA attention with RoPE, KV cache, and KV-chunked (online-softmax) path.

Twin of ``repro.layers.attention``. The chunked path loops over KV blocks
with a running (max, sum, acc), flash-attention's math in tensor ops, so
a long prefill never materializes a full (S, S) score matrix. Decode
attends over the whole cache buffer with the unwritten tail masked. With
``cfg.attn_impl == "flash"`` a prompt longer than ``cfg.attn_chunk`` goes
through the K8 kernel (``kernels.ops.flash_attention``).

The cache is written in place (the reference returns an updated copy and
donates the old one). :func:`init_kv_cache` therefore allocates K and V
separately: the reference returns one zero array for both, harmless for
immutable arrays, but aliased buffers would let a write to K corrupt V.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.layers.rope import apply_rope
from repro_torch.models.base import ModelConfig, ParamInit, Params

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, S_max, K, hd), or (L, B, S_max, K, hd) stacked
    v: torch.Tensor    # (B, S_max, K, hd), or (L, B, S_max, K, hd) stacked
    length: int        # tokens currently valid


class GQA(Params):
    """Projections of grouped-query attention (with QKV bias for qwen)."""

    AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
            "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}

    def __init__(self, init: ParamInit, cfg: ModelConfig,
                 in_dim: int | None = None):
        super().__init__()
        d = in_dim or cfg.d_model
        h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = init.normal((d, h * hd))
        self.wk = init.normal((d, k * hd))
        self.wv = init.normal((d, k * hd))
        self.wo = init.normal((h * hd, cfg.d_model))
        if cfg.qkv_bias:
            self.bq = init.zeros((h * hd,))
            self.bk = init.zeros((k * hd,))
            self.bv = init.zeros((k * hd,))

    def forward(self, x, positions, cfg: ModelConfig,
                cache: Optional[KVCache] = None, rope: bool = True):
        return attention(self, x, positions, cfg, cache, rope)


def _project_qkv(p: GQA, x: torch.Tensor, cfg: ModelConfig):
    dt = cfg.dtype
    bsz, s, _ = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p.w("wq", dt)
    kk = x @ p.w("wk", dt)
    v = x @ p.w("wv", dt)
    if cfg.qkv_bias:
        q = q + p.w("bq", dt)
        kk = kk + p.w("bk", dt)
        v = v + p.w("bv", dt)
    return (q.reshape(bsz, s, h, hd), kk.reshape(bsz, s, k, hd),
            v.reshape(bsz, s, k, hd))


def _full_attention(q, k, v, q_pos, k_pos, causal, cfg: ModelConfig):
    """Unchunked attention (small-seq / decode). GQA group dim explicit.

    Scores in f32; P rounded to the compute dtype before P V, as in the
    reference.
    """
    bsz, sq, h, hd = q.shape
    kh = k.shape[2]
    hdv = v.shape[-1]
    g = h // kh
    qg = q.reshape(bsz, sq, kh, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        mask = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(cfg.dtype)
    ctx = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return ctx.reshape(bsz, sq, h, hdv)


def _chunked_attention(q, k, v, q_pos, k_pos, causal, cfg: ModelConfig):
    """Online-softmax loop over KV chunks (memory O(S·chunk)).

    P is rounded to the compute dtype before P V (f32 sums), as in the
    reference.
    """
    bsz, sq, h, hd = q.shape
    sk = k.shape[1]
    kh = k.shape[2]
    hdv = v.shape[-1]
    g = h // kh
    chunk = min(cfg.attn_chunk, sk)
    if sk % chunk:
        raise ValueError(f"chunked attention needs sk % chunk == 0; got "
                         f"sk={sk}, chunk={chunk}")
    qg = q.reshape(bsz, sq, kh, g, hd).to(torch.float32)
    scale = hd ** -0.5
    m = torch.full((bsz, kh, g, sq), NEG_INF, device=q.device)
    lsum = torch.zeros((bsz, kh, g, sq), device=q.device)
    acc = torch.zeros((bsz, kh, g, sq, hdv), device=q.device)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].to(torch.float32)
        vb = v[:, c0:c0 + chunk]
        kp = k_pos[:, c0:c0 + chunk]
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kb) * scale
        if causal:
            mask = kp[:, None, None, None, :] <= q_pos[:, None, None, :, None]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pmat = torch.exp(s - m_new[..., None])
        lsum = lsum * alpha + pmat.sum(dim=-1)
        upd = torch.einsum("bkgqs,bskh->bkgqh",
                           pmat.to(cfg.dtype).to(torch.float32),
                           vb.to(torch.float32))
        acc = acc * alpha[..., None] + upd
        m = m_new
    ctx = acc / torch.clamp(lsum[..., None], min=1e-30)
    ctx = ctx.permute(0, 3, 1, 2, 4).reshape(bsz, sq, h, hdv)
    return ctx.to(cfg.dtype)


def _long_attention(q, k, v, positions, causal, cfg: ModelConfig):
    """Attention over a prompt longer than ``cfg.attn_chunk``."""
    if cfg.attn_impl == "flash":
        from repro_torch.kernels.ops import flash_attention
        return flash_attention(q, k, v, causal=causal)
    return _chunked_attention(q, k, v, positions, positions, causal, cfg)


def attention(p: GQA, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, cache: Optional[KVCache] = None,
              rope: bool = True) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention. With a cache, writes new KV at ``cache.length``.

    x: (B, S, d_in); positions: (B, S). Returns (out (B, S, d_model),
    cache'), where cache' holds the same buffers and the new length.
    """
    dt = cfg.dtype
    q, k, v = _project_qkv(p, x, cfg)
    if rope:
        q = apply_rope(q, positions, frac=cfg.rope_frac, theta=cfg.rope_theta)
        k = apply_rope(k, positions, frac=cfg.rope_frac, theta=cfg.rope_theta)
    bsz, sq = x.shape[0], x.shape[1]

    if cache is not None:
        start, smax = cache.length, cache.k.shape[1]
        if start + sq > smax:
            raise ValueError(f"cache of {smax} tokens holds {start}; cannot "
                             f"append {sq}")
        cache.k[:, start:start + sq] = k.to(cache.k.dtype)
        cache.v[:, start:start + sq] = v.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, start + sq)
        if sq > cfg.attn_chunk:
            # Long prefill into an empty cache: attend over the fresh K/V,
            # not the cache buffer (exact when cache.length == 0, which is
            # the serving engine's prefill contract).
            ctx = _long_attention(q, k, v, positions, True, cfg)
        else:
            k_pos = torch.arange(smax, device=x.device).expand(bsz, smax)
            # Mask out the unwritten tail: beyond length is treated as future.
            k_pos = torch.where(k_pos < start + sq, k_pos,
                                torch.iinfo(torch.int32).max)
            ctx = _full_attention(q, cache.k.to(dt), cache.v.to(dt),
                                  positions, k_pos, True, cfg)
        out = ctx.reshape(bsz, sq, -1) @ p.w("wo", dt)
        return out, new_cache

    if sq > cfg.attn_chunk:
        ctx = _long_attention(q, k, v, positions, cfg.causal, cfg)
    else:
        ctx = _full_attention(q, k, v, positions, positions, cfg.causal, cfg)
    out = ctx.reshape(bsz, sq, -1) @ p.w("wo", dt)
    return out, None


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                  layers: int | None = None, device="cuda") -> KVCache:
    """An empty cache; with ``layers``, stacked over a leading layer axis.

    K and V are two allocations (see the module note).
    """
    dtype = dtype or cfg.dtype
    lead = () if layers is None else (layers,)
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)
