"""Depthwise causal 1-D convolution (K7): the CUDA kernel and its plain
version.

Twin of ``repro.kernels.conv1d``, Mamba2's conv frontend: a one-sided
stencil of depth K-1 along time, ``out[b, l, d] = sum_k w[k, d] *
x[b, l - (K-1) + k, d]`` with zeros before step 0, plus ``b[d]``.
:func:`conv1d_depthwise_causal` follows the device of its inputs: on CUDA
tensors it launches the hand-written kernel in
``repro_torch/csrc/conv1d.cu`` (or raises; it never falls back), on CPU
tensors it runs :func:`conv1d_depthwise_causal_plain`.

The plain version is the reference oracle's loop
(``repro.kernels.ref.conv1d_depthwise_causal``): pad K-1 zero steps in
front, ``out = 0``, ``out = out + x_shift[k] * w[k]`` in f32 for k in
order, ``+ b``, one rounding to ``x.dtype``. The kernel does the same f32
operations in the same order without contracting them into fused
multiply-adds, so the two agree bit for bit. ``bl`` is the reference's
time chunk (``_pick_bl``): a block's tile of time steps, which does not
change the result.

:data:`LAUNCHES` counts kernel launches (never the plain version).

Forward only, as the reference's Pallas kernel is: with grad enabled and
any input requiring grad, :func:`conv1d_depthwise_causal` raises on
either device before it dispatches. Training takes the plain conv
(``ssm_conv_impl="jnp"``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import refuse_grad

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES: dict[str, int] = {"conv1d": 0}

#: The largest conv width the kernel is instantiated for.
MAX_K = 8
#: The launch grid's y (time chunks) and z (batch) extents are capped here.
MAX_GRID_YZ = 65535

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DEF_BL = 512


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _pick_bl(length: int, bl: int) -> int:
    """The largest chunk <= ``bl`` that divides ``length`` (the reference's
    rule)."""
    bl = min(bl, length)
    while length % bl:
        bl -= 1
    return bl


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x (B, L, D) and w (K, D); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (x.shape[2],):
        raise ValueError(f"b must be (D,) = ({x.shape[2]},); got "
                         f"{tuple(b.shape)}")
    if 0 in x.shape:
        raise ValueError(f"empty x {tuple(x.shape)}")
    if not 1 <= w.shape[0] <= MAX_K:
        raise ValueError(f"conv1d takes widths K of 1 to {MAX_K}; got "
                         f"{w.shape[0]}")
    dtypes = {x.dtype, w.dtype} | ({b.dtype} if b is not None else set())
    if len(dtypes) != 1 or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv1d takes float32 or bfloat16 x, w, b of one "
                        f"dtype; got {sorted(map(str, dtypes))}")
    if len({t.device for t in (x, w, b) if t is not None}) != 1:
        raise ValueError("x, w and b must be on one device")


def conv1d_depthwise_causal_plain(x: torch.Tensor, w: torch.Tensor,
                                  b: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """The reference oracle's tap loop in f32 tensor ops."""
    k, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + length].to(torch.float32) * w[i].to(
            torch.float32)
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            bl: int) -> torch.Tensor:
    bsz, length, d = x.shape
    if not all(t.is_contiguous() for t in (x, w, b) if t is not None):
        raise ValueError("the conv1d kernel takes contiguous x, w, b")
    if length // bl > MAX_GRID_YZ or bsz > MAX_GRID_YZ:
        raise ValueError(f"the conv1d kernel takes at most {MAX_GRID_YZ} "
                         f"time chunks and batch rows; got L/bl="
                         f"{length // bl}, B={bsz}")
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, w, b, out) if t is not None]
    # 16-byte vectors along D where every row starts 16-byte aligned.
    vec = int(d * x.element_size() % 16 == 0
              and all(p % 16 == 0 for p in ptrs))
    with build.on_card(x, w, b, out) as stream:
        err = build.load("conv1d").repro_conv1d(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[x.dtype], bsz, length, d,
            w.shape[0], bl, vec, stream)
    if err != 0:
        raise RuntimeError(f"conv1d kernel launch failed: cudaError_t {err}")
    LAUNCHES["conv1d"] += 1
    return out


def conv1d_depthwise_causal(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor | None = None, *,
                            bl: int = _DEF_BL) -> torch.Tensor:
    """Depthwise causal conv: x (B, L, D), w (K, D), b (D,) -> (B, L, D).

    Single-device kernel (``ops.conv1d`` is the public entry).
    Forward only: raises ``GradientError`` when asked for a gradient.
    On ``meta`` tensors it returns an output of the result's shape; under
    ``hlo_analysis``'s counter the call is counted by its formula.
    """
    refuse_grad("the depthwise causal conv (K7)", x, w, b)
    _check(x, w, b)
    if bl < 1:
        raise ValueError(f"bl must be positive; got {bl}")
    obs = build.observer()
    if obs is not None:
        return obs.kernel("conv1d", (x, w, b), lambda: _route(x, w, b, bl))
    return _route(x, w, b, bl)


def _route(x, w, b, bl: int) -> torch.Tensor:
    if x.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return conv1d_depthwise_causal_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d runs on CUDA or CPU tensors; got "
                         f"{x.device}")
    return _launch(x, w, b, _pick_bl(x.shape[1], bl))
