"""Mamba2 (SSD, state-space duality) block: chunked scan and decode step
(twin of ``repro.layers.ssm``).

Within a chunk the recurrence is a masked attention-like product; across
chunks a short loop carries the (G, M, P, N) state. The depthwise causal
conv frontend runs through K7 (``cfg.ssm_conv_impl == "pallas"``) or its
plain version (``"jnp"``).

Shapes: x (B, L, D); heads H = d_inner / head_dim P, in G groups of M;
B/C share G groups of state width N; dt per head. The SSD products take
their inputs rounded to the compute dtype and accumulate in f32 (the
reference's ``preferred_element_type=f32``); the decay math stays f32.
The reference's sharding hints are dropped: the port runs on one device.
"""
from __future__ import annotations

import types
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import constrain, view
from repro_torch.kernels import ops
from repro_torch.layers.basic import rms_norm
from repro_torch.models.base import ModelConfig, ParamInit, Params

NEG_INF = -1e30


class SSMCache(NamedTuple):
    state: torch.Tensor    # (B, G, M, P, N) f32: SSD state per head
    conv: torch.Tensor     # (B, K-1, conv_dim): the last pre-conv inputs


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


class SSM(Params):
    """The Mamba2 block's parameters, named as the reference's tree."""

    AXES = {"z_proj": ("embed", "ssm_inner"),
            "xbc_proj": ("embed", "ssm_inner"),
            "dt_proj": ("embed", "heads"), "conv_w": (None, "ssm_inner"),
            "conv_b": ("ssm_inner",), "A_log": ("heads",), "D": ("heads",),
            "dt_bias": ("heads",), "norm_scale": (None,),
            "out_proj": ("ssm_inner", "embed")}

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, di, h, k = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_conv
        cd = conv_dim(cfg)
        self.z_proj = init.normal((d, di))
        self.xbc_proj = init.normal((d, cd))
        self.dt_proj = init.normal((d, h))
        self.conv_w = init.normal((k, cd), scale=0.5)
        self.conv_b = init.zeros((cd,))
        # A in (-1, 0): A_log so that A = -exp(A_log) lies in [-4, -0.5].
        self.A_log = init.const(torch.log(torch.linspace(0.5, 4.0, h)))
        self.D = init.ones((h,))
        self.dt_bias = init.zeros((h,))
        self.norm_scale = init.ones((di,))
        self.out_proj = init.normal((di, d))


def _f32(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, then widened: an einsum input."""
    return t.to(dtype).to(torch.float32)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _silu_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(dtype)


def _conv(p: SSM, xbc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv + silu; weights cast to the compute dtype."""
    w = p.w("conv_w", xbc.dtype)
    b = p.w("conv_b", xbc.dtype)
    y = ops.conv1d(xbc, w, b, use_kernel=cfg.ssm_conv_impl == "pallas")
    return _silu_as(y, xbc.dtype)


def ssd_scan(x, dt, a, bmat, cmat, chunk: int, dtype):
    """Chunked SSD. x (b,l,g,m,p); dt (b,l,g,m); a (g,m); b/c (b,l,g,n).

    Returns (y (b,l,g,m,p) in ``dtype``, final_state (b,g,m,p,n) f32).
    """
    b, l, g, m, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"ssd_scan needs l % min(chunk, l) == 0; got "
                         f"l={l}, chunk={chunk}")
    nc = l // q
    f32 = torch.float32

    xr = x.reshape(b, nc, q, g, m, p)
    dtr = dt.reshape(b, nc, q, g, m).to(f32)
    br = bmat.reshape(b, nc, q, g, n)
    cr = cmat.reshape(b, nc, q, g, n)

    da = dtr * a                                  # (b,nc,q,g,m), negative
    da_cs = torch.cumsum(da, dim=2)
    da_sum = da_cs[:, :, -1]                      # (b,nc,g,m)

    # ---- intra-chunk (masked attention-like) ----
    scores = torch.einsum("bcqgn,bckgn->bcgqk", _f32(cr, dtype),
                          _f32(br, dtype))
    dac = da_cs.permute(0, 1, 3, 4, 2)            # (b,nc,g,m,q)
    diff = dac[..., :, None] - dac[..., None, :]  # (b,nc,g,m,q,k)
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(torch.where(tril, diff, NEG_INF))
    w = scores[:, :, :, None] * lmat              # (b,nc,g,m,q,k)
    dtx = dtr[..., None] * xr.to(f32)             # (b,nc,q,g,m,p)
    y_diag = torch.einsum("bcgmqk,bckgmp->bcqgmp", _f32(w, dtype),
                          _f32(dtx, dtype))

    # ---- chunk states ----
    decay_out = torch.exp(da_sum[:, :, None] - da_cs)   # (b,nc,q,g,m)
    sdt = decay_out * dtr
    states = torch.einsum("bckgn,bckgm,bckgmp->bcgmpn", _f32(br, dtype),
                          _f32(sdt, dtype), _f32(xr, dtype))

    # ---- inter-chunk recurrence (the reference's lax.scan) ----
    decay_chunk = torch.exp(da_sum)[..., None, None]    # (b,nc,g,m,1,1)
    s = torch.zeros((b, g, m, p, n), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * decay_chunk[:, c] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (b,nc,g,m,p,n)

    # ---- state -> output within chunk ----
    state_decay = torch.exp(da_cs)                       # (b,nc,q,g,m)
    y_inter = torch.einsum("bcqgn,bcgmpn->bcqgmp", _f32(cr, dtype),
                           _f32(prev_states, dtype))
    y_inter = y_inter * state_decay[..., None]

    y = (y_diag + y_inter).reshape(b, l, g, m, p)
    return y.to(dtype), s


def _ssd(x, dt, a, bmat, cmat, chunk: int, dtype):
    """:func:`ssd_scan`; under a ``DeviceMesh``, on each rank's blocks
    (``local_map``): the scan is independent over the batch and the
    heads, so x and dt split as they are laid out (batch over data,
    heads over model), ``a`` by its heads, B and C by the batch, and no
    collective runs."""
    mesh = shd._device_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return ssd_scan(x, dt, a, bmat, cmat, chunk, dtype)

    def keep(pl, dims):  # x's split of (batch, heads) onto other dims
        out = []
        for p in pl:
            d = p.dim if isinstance(p, Shard) else None
            out.append(Shard(dims[d]) if d in dims else Replicate())
        return tuple(out)

    xpl = x.placements
    if any(isinstance(p, Shard) and p.dim not in (0, 3) for p in xpl):
        raise ValueError(f"the SSD scan splits batch and heads only: "
                         f"{xpl}")

    def local(*blocks):
        with shd.local_blocks():
            return ssd_scan(*blocks, chunk, dtype)

    return local_map(
        local, out_placements=(xpl, keep(xpl, {0: 0, 3: 2})),
        in_placements=(xpl, keep(xpl, {0: 0, 3: 3}), keep(xpl, {3: 1}),
                       keep(xpl, {0: 0}), keep(xpl, {0: 0})),
        device_mesh=mesh, redistribute_inputs=True)(x, dt, a, bmat, cmat)


def _gated_out(p: SSM, y: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Gated RMS norm (mamba2's RMSNormGated), norm(y * silu(z)), then the
    out projection."""
    dt_ = cfg.dtype
    y = y * _silu_as(z, dt_)
    y = rms_norm(types.SimpleNamespace(scale=p.norm_scale), y, cfg.norm_eps)
    return constrain(y @ p.w("out_proj", dt_), ("batch", None, None))


def ssm_block(p: SSM, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[SSMCache] = None
              ) -> tuple[torch.Tensor, Optional[SSMCache]]:
    """Full Mamba2 block: proj -> conv -> SSD -> gated norm -> out proj.

    With a cache, ``l == 1`` is a decode step; a longer ``x`` is a prefill
    that starts from zero state (as the reference's does) and returns the
    new cache.
    """
    dt_ = cfg.dtype
    bsz, l, _ = x.shape
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    m = cfg.ssm_heads // g
    pdim, k = cfg.ssm_head_dim, cfg.ssm_conv

    x = constrain(x, ("batch", None, None))  # TP's input, whole
    inner = ("batch", None, "ssm_inner")
    z = constrain(x @ p.w("z_proj", dt_), inner)
    xbc_pre = constrain(x @ p.w("xbc_proj", dt_), inner)
    dt_raw = x @ p.w("dt_proj", dt_)

    if cache is not None and l == 1:
        return _ssm_decode_step(p, z, xbc_pre, dt_raw, cfg, cache)

    # Under a mesh the conv runs on the channels' split, and its output is
    # gathered whole for the split into x, B and C.
    xbc = constrain(_conv(p, xbc_pre, cfg), ("batch", None, None))
    xs, bc = xbc[..., :di], xbc[..., di:]
    bc = view(bc, (bsz, l, 2, g, n), ("batch", None, None, None, None))
    bmat, cmat = bc[:, :, 0], bc[:, :, 1]

    dt = _softplus(dt_raw.to(torch.float32) + p.dt_bias.to(torch.float32))
    a = -view(torch.exp(p.A_log.to(torch.float32)), (g, m), (None, "heads"))

    heads = ("batch", None, None, "heads", None)
    xh = view(xs, (bsz, l, g, m, pdim), heads)
    y, final_state = _ssd(xh, view(dt, (bsz, l, g, m), heads[:4]), a, bmat,
                          cmat, cfg.ssm_chunk, dt_)
    y = y + (view(p.D.to(torch.float32), (1, 1, g, m, 1),
                  (None, None, None, "heads", None))
             * xh.to(torch.float32)).to(dt_)
    out = _gated_out(p, view(y, (bsz, l, di), inner), z, cfg)

    new_cache = None
    if cache is not None:
        # The last K-1 pre-conv inputs carry the conv into decode; a prompt
        # shorter than that is led by the conv's zeros.
        tail = xbc_pre[:, max(l - (k - 1), 0):]
        tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
        new_cache = SSMCache(state=final_state, conv=tail)
    return out, new_cache


def _ssm_decode_step(p: SSM, z, xbc_new, dt_raw, cfg: ModelConfig,
                     cache: SSMCache):
    """Single-token state update (O(1) in context length)."""
    dt_ = cfg.dtype
    f32 = torch.float32
    bsz = z.shape[0]
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    m = cfg.ssm_heads // g
    pdim = cfg.ssm_head_dim

    # Conv over the (K-1)-token tail + the new token, with the f32
    # parameters (prefill's conv casts them to the compute dtype first).
    window = torch.cat([cache.conv, xbc_new], dim=1)          # (B, K, conv)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32), p.conv_w.to(f32))
    conv_out = conv_out + p.conv_b.to(f32)
    xbc = F.silu(conv_out).to(dt_)                            # (B, conv)
    new_conv = window[:, 1:, :]

    xs, bc = xbc[:, :di], xbc[:, di:]
    bc = bc.reshape(bsz, 2, g, n)
    bmat, cmat = bc[:, 0], bc[:, 1]                           # (B,g,n)

    dt = _softplus(dt_raw[:, 0].to(f32)
                  + p.dt_bias.to(f32)).reshape(bsz, g, m)
    a = -torch.exp(p.A_log.to(f32)).reshape(1, g, m)
    xh = xs.reshape(bsz, g, m, pdim).to(f32)

    da = torch.exp(dt * a)                                    # (B,g,m)
    upd = torch.einsum("bgn,bgm,bgmp->bgmpn", bmat.to(f32), dt, xh)
    state = cache.state * da[..., None, None] + upd
    y = torch.einsum("bgn,bgmpn->bgmp", cmat.to(f32), state)
    y = y + p.D.to(f32).reshape(1, g, m, 1) * xh
    out = _gated_out(p, y.reshape(bsz, 1, di).to(dt_), z, cfg)
    return out, SSMCache(state=state, conv=new_conv)


def init_ssm_cache(cfg: ModelConfig, batch: int, *, layers: int | None = None,
                   device="cuda") -> SSMCache:
    """An empty cache, its conv tail in the compute dtype; with ``layers``,
    stacked over a leading layer axis."""
    g = cfg.ssm_groups
    lead = () if layers is None else (layers,)
    return SSMCache(
        state=torch.zeros((*lead, batch, g, cfg.ssm_heads // g,
                           cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                         dtype=cfg.dtype, device=device),
    )
