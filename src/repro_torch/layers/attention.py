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

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import constrain, on_mesh, view, write_slice
from repro_torch.layers.rope import apply_rope
from repro_torch.models.base import ModelConfig, ParamInit, Params

NEG_INF = -1e30
#: The queries grouped by KV head: KV heads take the model axis when they
#: divide it, otherwise the GQA group, otherwise the query sequence
#: (context parallelism), as the reference constrains them.
QG_AXES = ("batch", "qseq", "kv_heads", "heads", None)


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
    x = constrain(x, ("batch", None, None))  # TP's input, whole
    q = x @ p.w("wq", dt)
    kk = x @ p.w("wk", dt)
    v = x @ p.w("wv", dt)
    if cfg.qkv_bias:
        q = q + p.w("bq", dt)
        kk = kk + p.w("bk", dt)
        v = v + p.w("bv", dt)
    return (view(q, (bsz, s, h, hd), ("batch", "qseq", "heads", None)),
            view(kk, (bsz, s, k, hd), ("batch", None, "kv_heads", None)),
            view(v, (bsz, s, k, hd), ("batch", None, "kv_heads", None)))


def _attend(core, qg, k, v, q_pos, k_pos, *args):
    """``core(qg, k, v, q_pos, k_pos, *args)``: under a ``DeviceMesh``,
    on each rank's blocks (``local_map``), where the keys' sequence is
    whole: the layout the reference's constraints ask for (batch over
    data, KV heads over model where they divide it, else the GQA group,
    else the query sequence) leaves every rank the keys its queries
    attend to, so attention needs no collective, as in GSPMD's partition
    of it. A decode step's cache splits the keys' sequence: its core
    runs on the DTensors, the softmax's reduction over the split."""
    mesh = shd._device_mesh()
    if mesh is None or not isinstance(qg, DTensor) or any(
            isinstance(p, Shard) and p.dim == 1
            for t in (k, v) for p in t.placements):
        return core(qg, k, v, q_pos, k_pos, *args)

    def pos(pl):  # positions (B, S) split as the batch and sequence dims
        return tuple(p if isinstance(p, Shard) and p.dim < 2
                     else Replicate() for p in pl)

    def local(*blocks):
        with shd.local_blocks():
            return core(*blocks, *args)

    return local_map(
        local, out_placements=(qg.placements,),
        in_placements=(qg.placements, k.placements, v.placements,
                       pos(qg.placements), pos(k.placements)),
        device_mesh=mesh, redistribute_inputs=True)(
        qg, k, v, shd.on_mesh(q_pos), shd.on_mesh(k_pos))


def _full_core(qg, k, v, q_pos, k_pos, causal, dtype):
    """Attention of the queries grouped by KV head, qg (B, Sq, K, G, hd),
    over k/v (B, Sk, K, hd): ctx (B, Sq, K, G, hdv)."""
    scale = qg.shape[-1] ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        mask = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


def _full_attention(q, k, v, q_pos, k_pos, causal, cfg: ModelConfig):
    """Unchunked attention (small-seq / decode). GQA group dim explicit.

    Scores in f32; P rounded to the compute dtype before P V, as in the
    reference.
    """
    bsz, sq, h, hd = q.shape
    kh = k.shape[2]
    hdv = v.shape[-1]
    qg = view(q, (bsz, sq, kh, h // kh, hd), QG_AXES)
    ctx = _attend(_full_core, qg, k, v, q_pos, k_pos, causal, cfg.dtype)
    return view(ctx, (bsz, sq, h, hdv), ("batch", "qseq", "heads", None))


def _chunked_core(qg, k, v, q_pos, k_pos, causal, dtype, chunk):
    """:func:`_full_core` as an online-softmax loop over KV chunks; ctx in
    f32."""
    bsz, sq, kh, g, hd = qg.shape
    sk = k.shape[1]
    hdv = v.shape[-1]
    qg = qg.to(torch.float32)
    scale = hd ** -0.5
    m = torch.full((bsz, kh, g, sq), NEG_INF, device=qg.device)
    lsum = torch.zeros((bsz, kh, g, sq), device=qg.device)
    acc = torch.zeros((bsz, kh, g, sq, hdv), device=qg.device)
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
                           pmat.to(dtype).to(torch.float32),
                           vb.to(torch.float32))
        acc = acc * alpha[..., None] + upd
        m = m_new
    ctx = acc / torch.clamp(lsum[..., None], min=1e-30)
    return ctx.permute(0, 3, 1, 2, 4)


def _chunked_attention(q, k, v, q_pos, k_pos, causal, cfg: ModelConfig):
    """Online-softmax loop over KV chunks (memory O(S·chunk)).

    P is rounded to the compute dtype before P V (f32 sums), as in the
    reference. Under a ``DeviceMesh`` the loop runs on each rank's blocks
    (:func:`_attend`).
    """
    bsz, sq, h, hd = q.shape
    sk = k.shape[1]
    kh = k.shape[2]
    hdv = v.shape[-1]
    chunk = min(cfg.attn_chunk, sk)
    if sk % chunk:
        raise ValueError(f"chunked attention needs sk % chunk == 0; got "
                         f"sk={sk}, chunk={chunk}")
    qg = view(q, (bsz, sq, kh, h // kh, hd), QG_AXES)
    k = constrain(k, ("batch", None, "kv_heads", None))
    v = constrain(v, ("batch", None, "kv_heads", None))
    ctx = _attend(_chunked_core, qg, k, v, q_pos, k_pos, causal, cfg.dtype,
                  chunk)
    ctx = view(ctx, (bsz, sq, h, hdv), ("batch", "qseq", "heads", None))
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
        write_slice(cache.k, 1, start, k.to(cache.k.dtype))
        write_slice(cache.v, 1, start, v.to(cache.v.dtype))
        new_cache = KVCache(cache.k, cache.v, start + sq)
        if sq > cfg.attn_chunk:
            # Long prefill into an empty cache: attend over the fresh K/V,
            # not the cache buffer (exact when cache.length == 0, which is
            # the serving engine's prefill contract).
            ctx = _long_attention(q, k, v, positions, True, cfg)
        else:
            k_pos = on_mesh(torch.arange(smax, device=x.device)
                            .expand(bsz, smax))
            # Mask out the unwritten tail: beyond length is treated as future.
            k_pos = torch.where(k_pos < start + sq, k_pos,
                                torch.iinfo(torch.int32).max)
            ctx = _full_attention(q, cache.k.to(dt), cache.v.to(dt),
                                  positions, k_pos, True, cfg)
        out = view(ctx, (bsz, sq, -1), ("batch", None, "heads")) \
            @ p.w("wo", dt)
        return constrain(out, ("batch", None, None)), new_cache

    if sq > cfg.attn_chunk:
        ctx = _long_attention(q, k, v, positions, cfg.causal, cfg)
    else:
        ctx = _full_attention(q, k, v, positions, positions, cfg.causal, cfg)
    out = view(ctx, (bsz, sq, -1), ("batch", None, "heads")) @ p.w("wo", dt)
    return constrain(out, ("batch", None, None)), None


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
