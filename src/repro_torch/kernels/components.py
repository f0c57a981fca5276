"""Table II's component ablation kernels (K6a–b): CUDA kernels and their
plain versions.

The paper locates its stencil's bottleneck by running parts of the
pipeline alone. The JAX package keeps the two kernels of that ablation
in ``benchmarks/table2_components.py``; the port keeps them here:

* :func:`dma_only` (K6a): moves each ``(bm + 2)``-row window of ``u``
  through fast memory and writes its interior, ``u[1:-1, 1:-1]``, with no
  math;
* :func:`compute_only` (K6b): the Jacobi sweep's arithmetic on resident
  data, ``((c + c + c + c) * 0.25)`` in f32, rounded once to ``u.dtype``.

Each follows the device of its input: on a CUDA tensor it launches its
hand-written kernel in ``repro_torch/csrc/stream.cu`` (or raises; it never
falls back), on a CPU tensor it runs its ``*_plain`` version. ``bm`` is
the row block; it does not change the result.

Unlike the reference, both write every output row. The reference's grids
cover ``(h - 2) // bm`` and ``h // bm`` blocks, so rows past the last
whole block are left unwritten (Table II's 514 x 514 grid at bm = 64
leaves two); here the last block is ragged.

:data:`LAUNCHES` counts kernel launches (never the plain versions).
"""
from __future__ import annotations

import torch

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES: dict[str, int] = {"dma_only": 0, "compute_only": 0}

_COMPUTE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MOVE_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
#: Largest K6a row block: its window, (bm + 2) rows of a 512-byte column
#: chunk, stages through shared memory.
MAX_DMA_BM = 256
#: K6b's row blocks run along the launch grid's y extent.
MAX_GRID_Y = 65535


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(u: torch.Tensor, bm: int, dtypes, least: int) -> None:
    if u.dim() != 2 or min(u.shape) < least:
        raise ValueError(f"u must be an (h, w) array with h, w >= {least}; "
                         f"got {tuple(u.shape)}")
    if u.dtype not in dtypes:
        raise TypeError(f"takes {[str(d) for d in dtypes]}; got {u.dtype}")
    if bm < 1:
        raise ValueError(f"bm must be positive; got {bm}")


def _on_card(u: torch.Tensor) -> bool:
    if u.device.type == "cpu":
        return False
    if u.device.type != "cuda":
        raise ValueError(f"runs on CUDA or CPU tensors; got {u.device}")
    if not u.is_contiguous():
        raise ValueError("the kernel takes a contiguous u")
    return True


def _launch(name: str, fn: str, u: torch.Tensor, out: torch.Tensor,
            *args: int) -> torch.Tensor:
    from repro_torch.kernels.build import load, on_card
    with on_card(u, out) as stream:
        err = getattr(load("stream"), fn)(u.data_ptr(), out.data_ptr(),
                                          *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def dma_only_plain(u: torch.Tensor, *, bm: int = 64) -> torch.Tensor:
    """The interior ``u[1:-1, 1:-1]`` as a new array."""
    _check(u, bm, _MOVE_DTYPES, 3)
    return u[1:-1, 1:-1].clone(memory_format=torch.contiguous_format)


def dma_only(u: torch.Tensor, *, bm: int = 64) -> torch.Tensor:
    """Move (bm + 2)-row windows and write their interiors, no math (K6a):
    (h, w) -> (h - 2, w - 2)."""
    _check(u, bm, _MOVE_DTYPES, 3)
    if not _on_card(u):
        return dma_only_plain(u, bm=bm)
    if bm > MAX_DMA_BM:
        raise ValueError(f"the dma_only kernel takes bm <= {MAX_DMA_BM}; "
                         f"got {bm}")
    h, w = u.shape
    out = torch.empty((h - 2, w - 2), dtype=u.dtype, device=u.device)
    return _launch("dma_only", "repro_dma_only", u, out, u.element_size(),
                   h, w, bm)


def compute_only_plain(u: torch.Tensor, *, bm: int = 64) -> torch.Tensor:
    """``((c + c + c + c) * 0.25)`` in f32, rounded once to ``u.dtype``."""
    _check(u, bm, tuple(_COMPUTE_CODE), 1)
    c = u.to(torch.float32)
    return ((c + c + c + c) * 0.25).to(u.dtype)


def compute_only(u: torch.Tensor, *, bm: int = 64) -> torch.Tensor:
    """The sweep's arithmetic on resident (bm, w) blocks, no halo (K6b)."""
    _check(u, bm, tuple(_COMPUTE_CODE), 1)
    if not _on_card(u):
        return compute_only_plain(u, bm=bm)
    h, w = u.shape
    if -(-h // bm) > MAX_GRID_Y:
        raise ValueError(f"the compute_only kernel takes at most "
                         f"{MAX_GRID_Y} row blocks; got {-(-h // bm)}")
    return _launch("compute_only", "repro_compute_only", u,
                   torch.empty_like(u), _COMPUTE_CODE[u.dtype], h, w, bm)
