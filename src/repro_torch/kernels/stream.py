"""The memory-access study's streaming kernels (K5a–c): CUDA kernels and
their plain versions.

Twin of ``repro.kernels.stream``, the paper's §V study (Tables III–VI)
of how data moves between device memory and a core:

* :func:`stream_copy` (K5a): a blocked identity copy; the block width
  ``bn`` sets how many contiguous bytes each row's transaction moves;
* :func:`stream_copy_rowdma` (K5b): the same copy issued as one
  asynchronous copy a row, waiting after each row (``sync=True``) or
  keeping rows in flight (``sync=False``);
* :func:`stream_replicated` (K5c): every block read ``factor`` times.

:func:`l2_read_probe` is no port: it measures the rate at which the card's
L2 serves K5c's re-reads (the same volatile 16-byte loads), the rate
K5c's bound is priced at.

Each follows the device of its input: on a CUDA tensor it launches its
hand-written kernel in ``repro_torch/csrc/stream.cu`` (or raises; it never
falls back), on a CPU tensor it runs its ``*_plain`` version. They take
int32, float32 and bfloat16 arrays of shape (h, w), as the tables call
them, and return a new array.

:func:`stream_replicated` computes the reference *kernel's* value, not
its oracle's: ``factor`` reads of ``x`` widened to f32 and added in order
from 0, rounded once to ``x.dtype`` (truncating toward zero for int32, as
JAX's ``astype`` does). The oracle ``repro.kernels.ref.stream_replicated``
multiplies by ``factor`` instead, which rounds differently in f32.

:data:`LAUNCHES` counts kernel launches (never the plain versions).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES: dict[str, int] = {"stream_copy": 0, "stream_copy_rowdma": 0,
                            "stream_replicated": 0}

#: Dtype codes of the kernels that widen to f32.
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
#: Shared memory a K5b block may give its ring of rows.
RING_BYTES = 227 * 1024 - 128
#: K5c's blocks tile rows 32 at a time along the launch grid's y extent.
MAX_REPLICATED_ROWS = 32 * 65535
#: The L2 probe's loads in flight a thread, the layouts it is compiled for.
PROBE_UNROLLS = (4, 8)


def probe_tile(unroll: int) -> int:
    """Bytes of one L2 probe block's tile (``csrc/stream.cu``: 256 threads x
    ``unroll`` 16-byte vectors)."""
    return 256 * unroll * 16


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(x: torch.Tensor, bm: int, bn: int | None = None) -> None:
    if x.dim() != 2 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (h, w) array; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the stream kernels take int32, float32 or "
                        f"bfloat16; got {x.dtype}")
    h, w = x.shape
    if bm < 1 or h % bm:
        raise ValueError(f"bm={bm} must be positive and divide h={h}")
    if bn is not None and (bn < 1 or w % bn):
        raise ValueError(f"bn={bn} must be positive and divide w={w}")


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the stream kernels run on CUDA or CPU tensors; "
                         f"got {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("the stream kernels take a contiguous x")
    return x.device.type


def _launch(name: str, fn: str, x: torch.Tensor, *args: int
            ) -> torch.Tensor:
    from repro_torch.kernels.build import load, on_card
    out = torch.empty_like(x)
    with on_card(x, out) as stream:
        err = getattr(load("stream"), fn)(x.data_ptr(), out.data_ptr(),
                                          *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def stream_copy_plain(x: torch.Tensor, *, bm: int, bn: int) -> torch.Tensor:
    """The identity copy the blocked kernel makes."""
    _check(x, bm, bn)
    return x.clone()


def copy_split(h: int, w: int, bm: int, bn: int, sms: int) -> int:
    """Blocks K5a gives each (bm, bn) tile: as many as keep the grid at
    about two blocks an SM on ``sms`` SMs without a third on any (1 once
    the tiles alone fill that), never more than the tile's ``bm`` rows."""
    tiles = (h // bm) * (w // bn)
    return max(1, min(bm, 2 * sms // tiles))


def stream_copy(x: torch.Tensor, *, bm: int, bn: int) -> torch.Tensor:
    """Blocked identity copy (K5a); block shape (bm, bn) sets the width of
    each row's transaction. A tile's rows may be split over several blocks
    (:func:`copy_split`); each row stays one bn-element span."""
    _check(x, bm, bn)
    if _device(x) == "cpu":
        return stream_copy_plain(x, bm=bm, bn=bn)
    h, w = x.shape
    units = -(-bn * x.element_size() // 16)  # 16-byte units a row span
    lanes = 1
    while lanes < min(units, 32):
        lanes *= 2
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _launch("stream_copy", "repro_stream_copy", x, x.element_size(),
                   h, w, bm, bn, lanes, copy_split(h, w, bm, bn, sms))


def stream_copy_rowdma_plain(x: torch.Tensor, *, bm: int,
                             sync: bool) -> torch.Tensor:
    """The identity copy the row-DMA kernel makes."""
    _check(x, bm)
    return x.clone()


class RowdmaPlan(NamedTuple):
    """How K5b runs: ``split`` blocks share each bm-row block's rows, and
    each stages its rows through ``ring`` row slots."""
    split: int
    ring: int


def rowdma_plan(row_bytes: int, bm: int, sync: bool) -> RowdmaPlan:
    """K5b's blocks and ring for rows of ``row_bytes``.

    Without ``sync`` every row is its own block, so all ``bm`` rows of a
    bm-row block are in flight at once, as the TPU keeps them. With
    ``sync`` a bm-row block is one block with one row in flight (the TPU's
    wait after each row), and a second slot, where two fit, takes the next
    row while the last one's store reads its own.
    """
    if not sync:
        return RowdmaPlan(bm, 1)
    return RowdmaPlan(1, min(2, RING_BYTES // row_bytes))


def stream_copy_rowdma(x: torch.Tensor, *, bm: int,
                       sync: bool) -> torch.Tensor:
    """Copy issued as one asynchronous copy a row each way (K5b), with a
    wait after each row (``sync``) or all rows in flight
    (:func:`rowdma_plan`).

    On the card each row is one ``cp.async.bulk`` in and one out, which
    move multiples of 16 bytes between 16-byte aligned addresses: rows of
    another width, or wider than :data:`RING_BYTES`, raise ``ValueError``.
    """
    _check(x, bm)
    if _device(x) == "cpu":
        return stream_copy_rowdma_plain(x, bm=bm, sync=sync)
    h, w = x.shape
    row_bytes = w * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"the row-DMA kernel copies 16-byte aligned rows "
                         f"of a multiple of 16 bytes; got rows of "
                         f"{row_bytes} bytes at offset {x.data_ptr() % 16}")
    if row_bytes > RING_BYTES:
        raise ValueError(f"a row of {row_bytes} bytes does not fit the "
                         f"row-DMA kernel's {RING_BYTES} bytes of shared "
                         f"memory")
    return _launch("stream_copy_rowdma", "repro_stream_rowdma", x,
                   x.element_size(), h, w, bm, *rowdma_plan(row_bytes, bm,
                                                            sync), int(sync))


def stream_replicated_plain(x: torch.Tensor, *, bm: int,
                            factor: int) -> torch.Tensor:
    """``factor`` reads of ``x`` summed in f32 in order, rounded once."""
    _check(x, bm)
    if factor < 1:
        raise ValueError(f"factor must be positive; got {factor}")
    xf = x.to(torch.float32)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for _ in range(factor):
        acc = acc + xf
    return acc.to(x.dtype)


def stream_replicated(x: torch.Tensor, *, bm: int,
                      factor: int) -> torch.Tensor:
    """Every block read ``factor`` times and accumulated (K5c)."""
    _check(x, bm)
    if factor < 1:
        raise ValueError(f"factor must be positive; got {factor}")
    if _device(x) == "cpu":
        return stream_replicated_plain(x, bm=bm, factor=factor)
    h, w = x.shape
    if h > MAX_REPLICATED_ROWS:
        raise ValueError(f"the replicated-read kernel takes at most "
                         f"{MAX_REPLICATED_ROWS} rows; got {h}")
    # 16-byte vectors along rows where every row starts 16-byte aligned
    # (the output is a fresh allocation, aligned like the allocator's).
    vec = int(w * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0)
    return _launch("stream_replicated", "repro_stream_replicated", x,
                   _DTYPE_CODE[x.dtype], h, w, factor, vec)


def l2_read_probe_plain(x: torch.Tensor, *, passes: int) -> torch.Tensor:
    """``passes`` x the sum of ``x``'s int32 words, mod 2**32, as int32."""
    total = int(x.to(torch.int64).sum()) * passes % 2**32
    return torch.tensor([total - 2**32 if total >= 2**31 else total],
                        dtype=torch.int32)


def l2_read_probe(x: torch.Tensor, *, passes: int,
                  unroll: int = 8) -> torch.Tensor:
    """Re-read the int32 buffer ``x`` ``passes`` times and return the
    words' wrapped sum (one int32, on ``x``'s device).

    On the card each block re-reads its own tile of :func:`probe_tile`
    bytes ``passes`` times with K5c's volatile 16-byte loads, ``unroll``
    (one of :data:`PROBE_UNROLLS`) in flight a thread; a buffer that fits
    the L2 (half of it, or less) is then read from the L2 on every pass
    after the first, so ``passes * x.nbytes`` over the kernel's time is the
    L2's read rate. A buffer of a whole number of tiles an SM gives every
    SM the same work.
    """
    if x.dtype != torch.int32 or x.numel() % 4 or x.numel() == 0:
        raise ValueError(f"the probe reads a non-empty int32 buffer of a "
                         f"multiple of 4 words; got {x.dtype} of "
                         f"{x.numel()}")
    if passes < 1:
        raise ValueError(f"passes must be positive; got {passes}")
    if unroll not in PROBE_UNROLLS:
        raise ValueError(f"the probe is compiled for unroll in "
                         f"{PROBE_UNROLLS}; got {unroll}")
    if _device(x) == "cpu":
        return l2_read_probe_plain(x, passes=passes)
    if x.data_ptr() % 16 or x.numel() // 4 >= 2**31:
        raise ValueError("the probe reads a 16-byte aligned buffer of "
                         "fewer than 2**31 vectors")
    from repro_torch.kernels.build import load, on_card
    out = torch.zeros(1, dtype=torch.int32, device=x.device)
    with on_card(x, out) as stream:
        err = load("stream").repro_l2_probe(
            x.data_ptr(), out.data_ptr(), x.numel() // 4, passes, unroll,
            stream)
    if err != 0:
        raise RuntimeError(f"l2_read_probe kernel launch failed: "
                           f"cudaError_t {err}")
    return out
