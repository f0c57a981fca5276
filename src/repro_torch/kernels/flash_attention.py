"""Fused flash-attention forward (K8): the CUDA kernels and the plain version.

Twin of ``repro.kernels.flash_attention``. :func:`flash_attention_local`
follows the device of its inputs: on CUDA tensors it launches a
hand-written kernel (or raises; it never falls back), on CPU tensors it
runs :func:`flash_attention_local_plain`.

The kernel is chosen by dtype, a rule and not a fallback:

* **bfloat16** goes to ``repro_torch/csrc/flash_attention_sm90.cu``, on
  the tensor cores: S = Q K^T from bf16 operands with f32 sums, scaled by
  ``hd**-0.5`` after the product; P split into its bf16 rounding and the
  bf16 rounding of the rest, two P V products with f32 sums (P to about
  16 bits: one bf16 P moved the qwen2.5-3b prefill logits out of their
  serving gate); the running max, the sum (of the f32 P) and the
  accumulator in f32; one rounding of ``acc / max(l, 1e-30)`` to bf16.
  128-key tiles (64 at hd 256); hd 80 and 112 padded to 128 with zeros
  inside the kernel. A bf16 input it does not take raises.
* **float32** goes to ``repro_torch/csrc/flash_attention.cu``, on the
  tensor cores in split TF32: q scaled by ``hd**-0.5`` in f32, each f32
  operand split into its TF32 rounding ``big`` and the TF32 rounding of
  the rest ``small``, and Q K^T and P V each formed as small*big +
  big*small + big*big with f32 sums (one TF32 product would miss the f32
  gate of 2e-5), on wgmma; P, the running max, the sum and the
  accumulator in f32; 32-key tiles.

The plain version is the TPU kernel's loop written with tensor ops: for
each block of ``bq`` query rows, an online softmax over key blocks of
``bk`` in order, causal key blocks past the block's last query skipped,
everything in f32 (P included), ``acc / max(l, 1e-30)`` rounded once to
``q.dtype``. The kernels compute the same function with their own key
tiles (see the notes in their sources); ``bq``/``bk`` therefore only
shape the plain version, and all keep the reference's precondition that
they divide the sequence lengths. Both kernels are held to the plain
version within 2e-5 in f32 and 3e-2 in bf16.

Forward only, as the reference's Pallas kernel is: with grad enabled and
any input requiring grad, :func:`flash_attention_local` raises on either
device before it dispatches (the reference's ``jax.grad`` through
``pallas_call`` fails too). Training takes ``attn_impl="jnp"``, the
plain chunked attention, which autograd differentiates. :data:`LAUNCHES`
counts kernel launches (never the plain version): ``flash_attention``
every launch of either kernel, ``flash_attention_wgmma`` those of the
bf16 kernel, ``flash_attention_tf32`` those of the f32 kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES: dict[str, int] = {"flash_attention": 0,
                             "flash_attention_wgmma": 0,
                             "flash_attention_tf32": 0}

#: Head dims both kernels are instantiated for, and their largest GQA
#: group. The bf16 kernel runs hd 80 and 112 in hd 128's layout, the
#: columns past hd filled with zeros by its loads.
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)
MAX_GROUP = 64

_DTYPES = (torch.float32, torch.bfloat16)


class GradientError(RuntimeError):
    """A forward-only kernel was asked for a gradient."""


def refuse_grad(what: str, *tensors) -> None:
    """Raise :class:`GradientError` when grad is enabled and any of
    ``tensors`` requires grad: the kernel has no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise GradientError(
            f"{what} is forward-only, as the reference's Pallas kernel is: "
            f"it has no backward. Run it under torch.no_grad(), or train "
            f"through the plain path (attn_impl='jnp', ssm_conv_impl='jnp')")


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int,
            bk: int) -> tuple[int, int]:
    """Check the shapes; return the effective (bq, bk)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Sq, H, hd) and k, v (B, Sk, K, hd) of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same batch and head dim, H a multiple of K)")
    sk = k.shape[1]
    if sq == 0 or sk == 0:
        raise ValueError("empty query or key sequence")
    bq, bk = min(bq, sq), min(bk, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"flash attention needs sq % bq == 0 and sk % bk "
                         f"== 0; got sq={sq}, bq={bq}, sk={sk}, bk={bk}")
    return bq, bk


def flash_attention_local_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                bq: int = 512, bk: int = 512) -> torch.Tensor:
    """The TPU kernel's tile loop in f32 tensor ops. Shapes as the kernel."""
    bq, bk = _blocks(q, k, v, bq, bk)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    dev = q.device
    # layout: (B, K, Sq, g, hd) for q; (B, K, Sk, hd) for k/v
    qr = (q.to(torch.float32) * scale).reshape(b, sq, kh, g, hd).permute(
        0, 2, 1, 3, 4)
    kr = k.to(torch.float32).permute(0, 2, 1, 3)
    vr = v.to(torch.float32).permute(0, 2, 1, 3)
    out = torch.empty((b, kh, sq, g, hd), dtype=torch.float32, device=dev)
    for qi in range(sq // bq):
        qb = qr[:, :, qi * bq:(qi + 1) * bq]
        q_pos = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((b, kh, bq, g), NEG_INF, device=dev)
        lsum = torch.zeros((b, kh, bq, g), device=dev)
        acc = torch.zeros((b, kh, bq, g, hd), device=dev)
        for j in range(sk // bk):
            if causal and j * bk > qi * bq + bq - 1:
                continue
            kb = kr[:, :, j * bk:(j + 1) * bk]
            vb = vr[:, :, j * bk:(j + 1) * bk]
            s = torch.einsum("bkqgd,bksd->bkqgs", qb, kb)
            if causal:
                k_pos = j * bk + torch.arange(bk, device=dev)
                mask = k_pos[None, :] <= q_pos[:, None]   # (bq, bk)
                s = torch.where(mask[:, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            lsum = lsum * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkqgs,bksd->bkqgd", p, vb)
            m = m_new
        out[:, :, qi * bq:(qi + 1) * bq] = acc / torch.clamp(
            lsum, min=1e-30)[..., None]
    return out.to(q.dtype).permute(0, 2, 1, 3, 4).reshape(b, sq, h, hd)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}; "
                         f"got {hd}")
    if h // kh > MAX_GROUP:
        raise ValueError(f"the flash kernel takes GQA groups of at most "
                         f"{MAX_GROUP} heads; got {h // kh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash kernel takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the flash kernels take 16-byte aligned q, k, v "
                         "(their TMA and cp.async loads need them)")
    wgmma = q.dtype == torch.bfloat16  # the route is chosen by dtype
    lib = "flash_attention_sm90" if wgmma else "flash_attention"
    out = torch.empty_like(q)
    with build.on_card(q, k, v, out) as stream:
        err = getattr(build.load(lib), f"repro_{lib}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, kh, hd, int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"{lib} kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES["flash_attention_wgmma" if wgmma else "flash_attention_tf32"] += 1
    return out


def flash_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, bq: int = 512,
                          bk: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd); H = K*g. Returns (B,Sq,H,hd).

    Single-device kernel (``ops.flash_attention`` is the public entry).
    Forward only: raises :class:`GradientError` when asked for a gradient.
    On ``meta`` tensors it returns an output of the result's shape (a
    shape-only run, as the dry run's); under ``hlo_analysis``'s counter
    the call is counted by its formula.
    """
    refuse_grad("flash attention (K8)", q, k, v)
    _blocks(q, k, v, bq, bk)
    obs = build.observer()
    if obs is not None:
        return obs.kernel("flash_attention", (q, k, causal),
                          lambda: _route(q, k, v, causal, bq, bk))
    return _route(q, k, v, causal, bq, bk)


def _route(q, k, v, causal: bool, bq: int, bk: int) -> torch.Tensor:
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_local_plain(q, k, v, causal=causal, bq=bq,
                                           bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors; got "
                         f"{q.device}")
    return _launch(q, k, v, causal)
