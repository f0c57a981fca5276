"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and report the build time;
3. hold each kernel (K1 temporal, K2 rowchunk, K3 dbuf, K4 shifted)
   against its plain PyTorch version on the card at 1026 x 9218 (the
   paper's 1024 x 9216 domain with its ring), for the 5-point, 9-point and
   a radius-2 spec, in f32 and bf16, K1 with and without a pin mask: all
   bit for bit, each K1, K2 and K3 call on its spec's compiled geometry;
   K2 and K3 also on the grid as a view one element into its storage
   (input and output) and at an odd width. Time each
   kernel, its plain version and, for one sweep,
   ``torch.nn.functional.conv2d`` as a yardstick (TF32 off). K2, K3 and
   conv2d are timed warm (calls back to back on one grid, which fits the
   50 MB L2 with its output) and cold (the calls rotate over grids of
   three times the L2), K2 and K3 beside their general kernel on the same
   work (the taps reversed). Every K1 case
   is timed beside the general K1 on the same work at its old tile (the
   parent's kernel) and two bounds: the f32 operations at the published
   peak, and at half of it (each multiply and add issued alone, as bit for
   bit requires). K4 is timed alone on pre-made tap views and as the whole
   policy call (the views' copies too), each beside its own traffic bound.
   Then the same kernels on inputs of magnitude up to 16x the smallest
   normal f32 (subnormal inputs, products and partial sums), bit for bit
   against their plain versions, which flush subnormals as XLA does; the
   built library's SASS must show every f32 multiply and add as ``.FTZ``
   (``csrc/stencil.cu`` is built with ``-ftz=true``);
4. the main path, ``engine.run(make_laplace_problem(1024, 9216),
   policy="auto", iters=1003)`` in bf16 and f32: the schedule must be 125
   temporal blocks of t=8 plus 3 rowchunk sweeps, the launch counters must
   show 125 K1 and 3 K2 launches, all on the compiled jacobi5 kernels,
   the result must equal the same schedule
   of plain functions bit for bit and be within f32 1e-4 / bf16 5e-2 of
   the reference policy run in f32 from the same start (the bf16 reference
   rounds after every sweep and drifts from the f32 solve; its drift is
   printed beside the error);
5. the other paths: ``step`` (auto picks dbuf: one K3 launch, on the
   jacobi5 kernel), the ``shifted`` policy (K4), ``run_converged`` with a
   tolerance that stops early, and ``run_batched`` with B=4 (3 K2 on the
   jacobi5 kernel), each lane equal to its solo run bit for bit;
6. K8 (flash attention) against its plain PyTorch version on the card, at
   the JAX package's test shapes, at GQA groups of 3 and 5, hd 256,
   lengths that are not a multiple of the key tile, at hd 112 (zamba2-7b:
   a ragged length, a GQA group of 2, and its serving shape B=4, S=2048,
   H=K=32, causal) and hd 80 (hubert-xlarge's heads: B=4, S=2048, H=K=16,
   non-causal, and a ragged causal case), and at qwen2.5-3b's serving
   shape B=4, S=2048, H=16, K=2, hd=128 causal, in f32 (rtol=atol=2e-5,
   the split-TF32 kernel) and bf16 (3e-2, the wgmma kernel), the JAX
   package's own tolerances; every case must have launched its dtype's
   kernel. At each S=2048 shape each route, its plain version and
   ``scaled_dot_product_attention`` (a yardstick only) are timed beside
   the bound (bf16 on the tensor cores' bf16 rate; f32 as done, three
   TF32 products at the TF32 rate, and, printed beside it with the
   kernel's share of each and its ratio to SDPA, on the CUDA cores' f32
   rate);
7. LM serving, the second main path: ``qwen2.5-3b`` at full width (36
   layers, d 2048) with ``attn_impl="flash"``, random weights from a
   seeded generator, ``ServeEngine(batch_size=4)`` serving 4 requests of
   2048-token prompts and 32 new greedy tokens. Every request must get 32
   tokens within the padded vocab, K8 must launch 36 times (once a layer
   in the one prefill wave), all 36 on the tensor-core kernel
   (``flash_attention_wgmma``), and the prefill logits must be within
   rtol=5e-2, atol=8e-2 of the same weights through ``attn_impl="jnp"``
   (the JAX package's own bound); both are also compared, as a
   diagnostic, with the same prefill in f32 compute, which must launch
   K8 36 times, all on the split-TF32 kernel (``flash_attention_tf32``),
   and nothing else. Prefill ms and
   decode ms a step (wall, and the kernels' device time from
   ``torch.profiler``: the device's busy share), prefill's kernels with
   the most device time, tok/s and peak memory are printed;
8. K7 (depthwise causal conv) against its plain PyTorch version on the
   card, bit for bit, at the JAX package's test shapes and at the serving
   shape B=4, L=2048, D=5376, K=4, in f32 and bf16, with and without a
   bias; at the serving shape the kernel, its plain version and a
   depthwise ``torch.nn.functional.conv1d`` (a yardstick only, TF32 off)
   are timed beside the bound;
9. SSM serving, the third main path: ``mamba2-2.7b`` at full width and
   depth (64 layers, d 2560, 80 SSD heads of 64, state 128) with
   ``ssm_conv_impl="pallas"``, random weights from a seeded generator,
   ``ServeEngine(batch_size=4)`` serving 4 requests of 2048-token prompts
   and 32 new greedy tokens. Every request must get 32 tokens within the
   padded vocab, K7 must launch 64 times (once a layer in the one prefill
   wave) and no other kernel of the port at all, the prefill logits must
   equal those of the same weights through ``ssm_conv_impl="jnp"`` (the
   plain conv on the card) bit for bit, and a second greedy run must give
   the same tokens. The gap to the same prefill in f32 compute, prefill
   and decode times (wall, and kernel time from ``torch.profiler``),
   prefill's kernels with the most device time, tok/s and peak memory are
   printed;
10. the memory-access study: K5a (``stream_copy``), K5b
    (``stream_copy_rowdma``), K5c (``stream_replicated``), K6a
    (``dma_only``) and K6b (``compute_only``) against their plain
    versions, bit for bit, at the JAX test shapes (odd blocks, widths 258
    and 1026, a ragged last block) and at the table shapes, in every dtype
    their tables use plus bf16; each timed at its main table shape beside
    its bound and, for the copies, ``Tensor.copy_`` (a yardstick only);
    K5a's split of a tile over blocks at bn 4096, and K5b's plan, its
    time against ``copy_`` and the ratio of ``sync=True`` to
    ``sync=False``, are printed. An L2 probe (K5c's volatile loads, each
    block re-reading its tile of a 12–25 MiB buffer 64 or 128 times, in
    ten layouts, each sum checked) and K5c's own (factor + 1) bytes over
    its time give the rate K5c's bound is priced at, the highest of them:
    HBM serves the first read and the write, the L2 every access; K5c's
    share of that bound is printed at each factor of Table V, and none
    may exceed 1.
    Then ``launch.access`` runs Tables II–VI on the card at the paper's
    sizes with the launch counters zeroed just before: every measured row
    must read ``us_per_call > 0`` and all five kernels must have launched;
11. hybrid serving, the fourth main path: ``zamba2-7b`` at full width and
    depth (81 mamba layers, d 3584, SSD heads of 64, state 64, in 13
    groups of 6 behind one shared attention block, 32 heads of hd 112,
    plus a tail of 3) with ``attn_impl="flash"`` and
    ``ssm_conv_impl="pallas"``, random weights from a seeded generator,
    ``ServeEngine(batch_size=4)`` serving 4 requests of 2048-token prompts
    and 32 new greedy tokens. Every request must get 32 tokens within the
    padded vocab; K8 must launch 13 times (once an application of the
    shared block in the one prefill wave), all on the tensor-core kernel,
    K7 81 times, and no other kernel of the port at all; the prefill
    logits must equal those through ``ssm_conv_impl="jnp"`` bit for bit;
    each application of the shared block through K8 must be within
    rtol=5e-2, atol=8e-2 of the ``attn_impl="jnp"`` route's (the JAX
    package's own bound), fed the serving path's own stream and fed the
    jnp route's, and so must the whole prefill's logits in f32 compute
    (K8's split-TF32 route, 13 launches). Prefill and decode times
    (wall, and kernel time from ``torch.profiler``), prefill's kernels
    with the most device time, tok/s and peak memory are printed, and a
    second greedy run must give the same tokens. The whole bf16 prefill's
    logits against the jnp route's (largest excess over rtol*|jnp|) and
    both routes' gaps to f32 compute are printed and not gated: on these
    random weights the SSD stack grows a one-ulp bf16 difference in the
    stream to O(1) at the logits, so two right routes fail that bound
    (the JAX package's own hybrid fails it between its routes at smoke
    size);
12. stencil solves as a service at the paper's grid: ``SolveServer``
    (max_slots 4, superblock 4, temporal, t 8) serves two f32 buckets
    (1024 x 9216 and 2048 x 4608 interiors, six requests each: five
    tolerances taken from each bucket's own solo residual curve, spread
    over an order of magnitude, and one fixed at 1000 sweeps) and a bf16
    bucket of two, then one lone f32 request through ``run_converged``.
    Every result must equal its solo ``engine.run`` at its realized count
    bit for bit, on a multiple of t, converged within its tol; the
    realized blocks must equal the solo curves'; superblock 1 must serve
    what superblock 4 serves; the served K1 launches (counters zeroed
    just before) must all be the jacobi5 kernel and number the trace's
    blocks (each superblock's block count plus each ``run_converged``'s),
    and the served K2 launches (a superblock's residuals, one a block)
    must all be the jacobi5 kernel and number the superblocks' blocks;
    ``SolveServer.warm`` must measure each tune cell once in f32 and bf16
    and not again, and ``policy="tuned"`` requests must equal their solo
    runs under the winner. Served wall time and GPt/s against one request
    at a time, sweeps saved, host waits a request, the device's busy
    share and its kernels are printed, and bench_serve's t=64 is put to
    admission;
13. the distributed stencil on one card: ``engine.run_distributed(u,
    policy="auto", iters=1003, t=8)`` on the paper's grid over a
    ``ShardMesh`` of four shards on the card, ``(4,)`` and ``(2, 2)``, in
    bf16 and f32, overlap off and on. First, on each mesh, K1 (masked)
    and K2 are held against their plain versions bit for bit at every
    shape and mask this path gives them, the masks the executor's own:
    each shard position's extended block with its pin mask and its four
    rind strips with theirs, the raw shard with the interior's all-zero
    mask; K2 at the remainder round's extended block, raw shard and
    strips. The default ``overlap=None`` must resolve to the serial round
    (the shards share one card: no link to hide), and the default call
    must launch and agree as the serial one. Each run's
    schedule must be 125 masked temporal rounds of t=8 plus one 3-sweep
    rowchunk round, its launches (counters zeroed just before) 125 K1 and
    3 K2 a shard serially, all on the jacobi5 kernels (with overlap: an
    interior and four rind strips a round, so five times as many), and
    its result ``torch.equal`` to the single-device ``engine.run(u,
    policy="temporal", t=8, iters=1003)``. Wall time (the median of five
    runs, and their range) and GPt/s of each run beside the
    single-device solve's, and the modeled exchange bill (serial and
    overlapped), are printed. Then the reference test's
    matrix on the card (jacobi5, a row stencil, a diagonal-tap one x the
    two meshes x reference, shifted, rowchunk, temporal x t 1, 3 x
    overlap on, off), each bit for bit the single-device rowchunk solve;
    then a traced run of the main path (bf16, ``(4,)``, overlap off and
    on), bit for bit the untraced one, whose spans ``reconcile`` joins
    against the bill;
14. the Grayskull e150 model on the card (``repro_torch.backends``): the
    backends smoke; at the paper's grid the f32 row-major and bf16
    tilized programs of every policy refused by the model's 1.5 MiB
    (each diagnostic printed: a 9218-cell row is 289 tiles of 32x32);
    ``backends.simulate(device="grayskull_e150", iters=11)`` of bf16
    row-major rowchunk (bm 16) and temporal (bm 4, t 4) at the paper's
    grid, and of every lowerable policy in f32 row-major and bf16
    tilized at 1024 x 1024 (bm 32, t 8: one fused block and a
    remainder), each grid ``torch.equal`` to the card's ``engine.run``
    of the same policy, iters, t and bm, whose K1–K4 launches are
    counted; per case the MODELED e150 GPt/s and energy beside the
    card's measured GPt/s for the same solve and the simulator's wall
    time; the four-card what-if (``mesh_shape=(4,)``, overlap off and
    on) of each temporal case, its grid equal to the single chip's; the
    ``sim.simulate`` span and counter tracks; and ``run_sweep(full=True)``,
    720 cells, the 540 off the GPU all verified as the reference's;
15. one JSON line listing the kernels, then the card's name and power
    limit, then the result line.

It imports nothing of JAX and nothing of the ``repro`` package, and exits
non-zero without a card or outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "drives the CUDA kernels and needs a card")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import backends, configs, engine  # noqa: E402
from repro_torch.analysis.sweep import run_sweep  # noqa: E402
from repro_torch.backends import report as sim_report  # noqa: E402
from repro_torch.core.stencil import (F32_TINY, StencilSpec,  # noqa: E402
                                      apply_stencil,
                                      jacobi_2d_5pt, laplace_2d_9pt,
                                      make_laplace_problem)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import components  # noqa: E402
from repro_torch.kernels import conv1d as conv  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import stream  # noqa: E402
from repro_torch.layers import basic  # noqa: E402
from repro_torch.launch import access  # noqa: E402
from repro_torch.launch.sweep_ab import cold_ms, cold_pairs  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.obs.timing import (device_ms, kernel_ms,  # noqa: E402
                                    top_kernels)

NY, NX, ITERS, T = 1024, 9216, 1003, 8
RADIUS2 = StencilSpec(offsets=((-2, 0), (-1, 0), (0, 0), (0, -2), (0, 1)),
                      weights=(0.1, 0.3, 0.2, 0.15, 0.25))
SPECS = {"jacobi5": jacobi_2d_5pt(), "laplace9": laplace_2d_9pt(),
         "radius2": RADIUS2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KERNELS = {  # policy -> (id, TPU kernel it replaces)
    "temporal": ("K1", "src/repro/engine/policies.py:286"),
    "rowchunk": ("K2", "src/repro/engine/policies.py:127"),
    "dbuf": ("K3", "src/repro/engine/policies.py:203"),
    "shifted": ("K4", "src/repro/engine/policies.py:83"),
}
SOURCE = "src/repro_torch/csrc/stencil.cu"
FLASH = ("K8", "src/repro/kernels/flash_attention.py:82")
# dtype -> (route, source): the kernel is chosen by dtype.
FLASH_ROUTES = {
    "bfloat16": ("wgmma", "src/repro_torch/csrc/flash_attention_sm90.cu"),
    "float32": ("tf32x3", "src/repro_torch/csrc/flash_attention.cu")}
# (B, S, H, K, hd, causal, bq=bk): the shapes of tests/test_kernels_flash.py
# at their 64-row blocks, GQA groups of 3 and 5, hd 256, lengths that are
# not a multiple of the key tile, hd 112 and 80, then the serving
# prefills' shapes: qwen2.5-3b's, zamba2-7b's (hd 112) and hubert-xlarge's
# heads (hd 80, non-causal).
FLASH_SHAPES = [(2, 128, 4, 2, 32, True, 64), (1, 256, 8, 8, 16, True, 64),
                (2, 128, 4, 1, 32, False, 64), (1, 64, 2, 2, 64, True, 64),
                (1, 192, 6, 2, 128, True, 64), (2, 96, 3, 3, 256, True, 32),
                (1, 128, 12, 4, 64, True, 64), (2, 300, 16, 2, 128, True, 300),
                (1, 130, 5, 1, 32, False, 130),
                (2, 300, 32, 32, 112, True, 300), (1, 256, 8, 4, 112, True, 64),
                (1, 300, 6, 3, 80, True, 300),
                (4, 2048, 16, 2, 128, True, 512),
                (4, 2048, 32, 32, 112, True, 512),
                (4, 2048, 16, 16, 80, False, 512)]
# head dim of a timed S=2048 shape -> the key of its stats
FLASH_TIMED = {128: "hd128", 112: "hd112", 80: "hd80"}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
CONV = ("K7", "src/repro_torch/csrc/conv1d.cu",
        "src/repro/kernels/conv1d.py:52")
# (B, L, D, K, bl): the shapes of tests/test_kernels_conv1d.py (bl=32
# there), then the serving prefill's (conv_dim 5376 of mamba2-2.7b).
CONV_SHAPES = [(1, 64, 128, 4, 32), (2, 128, 256, 4, 32),
               (3, 96, 128, 3, 32), (1, 32, 384, 2, 32),
               (4, 2048, 5376, 4, 512)]
PROMPT, NEW, WAVE = 2048, 32, 4
STREAM_SOURCE = "src/repro_torch/csrc/stream.cu"
STREAM = {  # wrapper -> (id, TPU kernel it replaces, its main table shape)
    "stream_copy": ("K5a", "src/repro/kernels/stream.py:36",
                    "4096x4096 int32 bm=256 bn=4096 (Table III, 16 KB rows)"),
    "stream_copy_rowdma": ("K5b", "src/repro/kernels/stream.py:70",
                           "4096x4096 int32 bm=64 sync=False (Table III)"),
    "stream_replicated": ("K5c", "src/repro/kernels/stream.py:100",
                          "4096x4096 float32 bm=128 factor=32 (Table V)"),
    "dma_only": ("K6a", "benchmarks/table2_components.py:37",
                 "1026x9218 bfloat16 bm=64 (Table II)"),
    "compute_only": ("K6b", "benchmarks/table2_components.py:52",
                     "1026x9218 bfloat16 bm=64 (Table II)"),
}


class Peaks(NamedTuple):
    """Data-sheet peaks: memory bytes/s, f32 FLOP/s outside the tensor
    cores, dense bf16 and dense TF32 FLOP/s on the tensor cores."""
    bw: float
    f32: float
    bf16: float
    tf32: float


PEAKS = {"H100 PCIe": Peaks(2.0e12, 51e12, 756e12, 378e12),
         "H100 NVL": Peaks(3.9e12, 60e12, 835e12, 418e12),
         "H200": Peaks(4.8e12, 67e12, 989e12, 495e12),
         "H100": Peaks(3.35e12, 67e12, 989e12, 495e12)}


def card() -> tuple[str, Peaks]:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in name), PEAKS["H100"])
    return line, peaks


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def grid(spec: StencilSpec, dtype, seed: int) -> torch.Tensor:
    r = spec.radius
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((NY + 2 * r, NX + 2 * r), generator=g,
                      device="cuda").to(dtype)


def bound_ms(policy: str, spec: StencilSpec, u: torch.Tensor, t: int,
             peaks, unfused: bool = False) -> tuple[float, str]:
    """Least time for the function: each input byte read once and each
    output byte written once, against the f32 operations it must do at
    the published peak, which counts a fused multiply-add as two; with
    ``unfused`` at half that rate, since the kernels must issue each
    multiply and add alone to stay bit for bit (no contraction)."""
    bw, flops = peaks.bw, peaks.f32 / (2 if unfused else 1)
    r = spec.radius
    hi, wi = u.shape[-2] - 2 * r, u.shape[-1] - 2 * r
    nbytes = u.numel() * u.element_size() + hi * wi * u.element_size()
    ops = (2 * spec.taps - 1) * hi * wi * (t if policy == "temporal" else 1)
    b_ms, o_ms = nbytes / bw * 1e3, ops / flops * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def shifted_kernel_bound_ms(spec: StencilSpec, u: torch.Tensor,
                            peaks) -> tuple[float, str]:
    """Least time for K4's own function on its pre-made operands: the taps'
    interior planes read once and the interior written once."""
    r = spec.radius
    plane = (u.shape[-2] - 2 * r) * (u.shape[-1] - 2 * r)
    b_ms = (spec.taps + 1) * plane * u.element_size() / peaks.bw * 1e3
    o_ms = (2 * spec.taps - 1) * plane / peaks.f32 * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def conv_yardstick(spec: StencilSpec, u: torch.Tensor):
    """One sweep's interior as one cuDNN convolution (timed only): of
    ``u``, or of the grid it is given."""
    r = spec.radius
    w = torch.zeros((1, 1, 2 * r + 1, 2 * r + 1), dtype=u.dtype,
                    device=u.device)
    for (dy, dx), wt in zip(spec.offsets, spec.weights):
        w[0, 0, dy + r, dx + r] = wt
    return lambda x=u: torch.nn.functional.conv2d(x[None, None], w)


VARIANTS = {"temporal": engine.TEMPORAL_VARIANTS,
            "rowchunk": engine.ROWCHUNK_VARIANTS,
            "dbuf": engine.DBUF_VARIANTS}


def sweep_off_path(policy: str, spec_name: str, spec: StencilSpec,
                   dname: str) -> None:
    """K2 or K3 where no row is 16-byte aligned the same way: the grid as
    a view one element into its storage (2 bytes in bf16), input and
    output both, and a grid of odd width (NX + 2r + 1); bit for bit, on
    the spec's kernel."""
    r, dtype = spec.radius, DTYPES[dname]
    fn = getattr(engine, f"stencil_{policy}")
    plain = getattr(engine, f"stencil_{policy}_plain")
    h, w = NY + 2 * r, NX + 2 * r
    g = torch.Generator(device="cuda").manual_seed(3)
    buf = torch.rand(h * w + 1, generator=g, device="cuda").to(dtype)
    u = buf[1:].view(h, w)
    out = torch.full_like(buf, -3.0)[1:].view(h, w)
    engine.policies.copy_ring(u, out, r)
    odd = torch.rand((h, w + 1), generator=g, device="cuda").to(dtype)
    before = dict(VARIANTS[policy])
    for label, grid_, kw in (("view at 1 element", u, {"out": out}),
                             (f"width {w + 1}", odd, {})):
        got = fn(grid_, spec, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, plain(grid_, spec)),
              f"{policy} {spec_name} {dname} {label} != its plain version")
    ran = {k: n - before[k] for k, n in VARIANTS[policy].items()}
    check(ran == {k: 2 * (k == spec_name) for k in ran},
          f"{policy} {spec_name} {dname} off the aligned path ran {ran}")
    print(f"{policy:16s} {spec_name:9s} {dname:8s} bitwise  as a view "
          f"at 1 element and at width {w + 1}")


def time_sweep(policy, spec, dname, u, out, p_ms, lib, peaks, s) -> None:
    """K2 or K3 at the paper grid: warm (calls back to back on one grid,
    which fits the L2 with its output), cold (the calls rotate over grids
    of three times the L2), the general kernel on the same work (the taps
    reversed), the bound, and conv2d warm and cold."""
    fn = getattr(engine, f"stencil_{policy}")
    rev = StencilSpec(spec.offsets[::-1], spec.weights[::-1])
    check(torch.equal(fn(u, rev), getattr(
        engine, f"stencil_{policy}_plain")(u, rev)),
        f"the general {policy} kernel != its plain version")
    k_ms = device_ms(lambda: fn(u, spec, out=out))
    g_ms = device_ms(lambda: fn(u, rev, out=out))
    pairs = cold_pairs(u, out)
    k_cold = cold_ms(lambda x, o: fn(x, spec, out=o), pairs)
    lib_ms = device_ms(lib)
    lib_cold = cold_ms(lambda x, o: lib(x), pairs)
    del pairs
    b_ms, b_by = bound_ms(policy, spec, u, 1, peaks)
    print(f"{policy:16s} {'jacobi5':9s} {dname:8s} bitwise  "
          f"kernel_ms={k_ms:.6f} kernel_cold_ms={k_cold:.6f} "
          f"general_ms={g_ms:.6f} plain_ms={p_ms:.6f} bound_ms={b_ms:.6f} "
          f"({b_by}; share warm {b_ms / k_ms:.1%}, cold {b_ms / k_cold:.1%})"
          f" library_ms={lib_ms:.6f} library_cold_ms={lib_cold:.6f}")
    s[dname] = {"ms": k_ms, "cold_ms": k_cold, "general_ms": g_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "library_cold_ms": lib_cold}


def general_k1(spec: StencilSpec, u: torch.Tensor, mask):
    """The general K1 (the parent's kernel, unchanged) at its old default
    tile, on the same work: the spec's taps in reverse order match no
    compiled geometry. Checked bit for bit against its plain version."""
    rev = StencilSpec(spec.offsets[::-1], spec.weights[::-1])
    plan = engine.plan_for(u.shape, u.dtype, rev, "temporal", t=T, bm=32,
                           bn=128, masked=mask is not None)
    before = engine.TEMPORAL_VARIANTS["general"]
    out = engine.policies.launch(plan, u, mask=mask)
    want = engine.stencil_temporal_plain(u, rev, t=T, mask=mask)
    torch.cuda.synchronize()
    check(torch.equal(out, want) and engine.TEMPORAL_VARIANTS["general"]
          == before + 1, "the general K1 != its plain version")
    return device_ms(lambda: engine.policies.launch(plan, u, out=out,
                                                    mask=mask))


def phase_kernels(peaks, stats) -> None:
    print("== phase 3: kernels vs plain versions, bit for bit, "
          f"{NY + 2}x{NX + 2} ==")
    for spec_name, spec in SPECS.items():
        variant = engine.plan.temporal_variant(spec)
        check(variant == spec_name, f"{spec_name} runs K1 {variant}")
        for dname, dtype in DTYPES.items():
            u = grid(spec, dtype, seed=len(spec_name))
            out = torch.empty_like(u)
            engine.policies.copy_ring(u, out, spec.radius)
            mask = torch.rand(u.shape, device="cuda") < 0.01
            cases = [(p, {}) for p in ("rowchunk", "dbuf", "shifted")]
            cases += [("temporal", {"t": T}), ("temporal", {"t": T,
                                                           "mask": mask})]
            for policy, kw in cases:
                counts = VARIANTS.get(policy, {})
                before = dict(counts)
                got = getattr(engine, f"stencil_{policy}")(u, spec, **kw)
                ran = {k: n - before[k] for k, n in counts.items()}
                want = getattr(engine, f"stencil_{policy}_plain")(u, spec,
                                                                  **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                label = policy + (" masked" if "mask" in kw else "")
                check(torch.equal(got, want),
                      f"{label} {spec_name} {dname}: max |err| {err}")
                check(ran == {k: int(k == variant) for k in ran},
                      f"{label} {spec_name} {dname} ran {ran}")
                s = stats.setdefault(policy, {"max_abs_err": 0.0})
                s["max_abs_err"] = max(s["max_abs_err"], err)
                if policy == "temporal":
                    time_k1(spec_name, spec, dname, u, out, kw, peaks, s)
                    continue
                if policy != "shifted":
                    sweep_off_path(policy, spec_name, spec, dname)
                if spec_name != "jacobi5":
                    print(f"{label:16s} {spec_name:9s} {dname:8s} bitwise")
                    continue
                fn = getattr(engine, f"stencil_{policy}")
                plain = getattr(engine, f"stencil_{policy}_plain")
                k_ms = device_ms(lambda: fn(u, spec, out=out, **kw))
                p_ms = device_ms(lambda: plain(u, spec, **kw), reps=3,
                                 inner=3)
                if policy != "shifted":
                    time_sweep(policy, spec, dname, u, out, p_ms,
                               conv_yardstick(spec, u), peaks, s)
                    continue
                lib_ms = device_ms(conv_yardstick(spec, u))
                b_ms, b_by = bound_ms(policy, spec, u, 1, peaks)
                time_k4(spec, dname, u, out, k_ms, p_ms, lib_ms, b_ms, peaks,
                        s)


def time_k1(spec_name, spec, dname, u, out, kw, peaks, s) -> None:
    """K1 on this (spec, dtype, mask): its compiled kernel, the general
    kernel on the same work, and both bounds; the plain version for
    jacobi5 unmasked, the row the kernels line reports."""
    mask = kw.get("mask")
    k_ms = device_ms(lambda: engine.stencil_temporal(u, spec, out=out,
                                                     **kw))
    g_ms = general_k1(spec, u, mask)
    b_ms, b_by = bound_ms("temporal", spec, u, T, peaks)
    nc_ms, nc_by = bound_ms("temporal", spec, u, T, peaks, unfused=True)
    label = "temporal" + (" masked" if mask is not None else "")
    row = {"ms": k_ms, "general_ms": g_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_nc_ms": nc_ms, "bound_nc_by": nc_by}
    s.setdefault("cases", {})[f"{spec_name} {dname}"
                              + (" masked" if mask is not None else "")] = row
    extra = ""
    if spec_name == "jacobi5" and mask is None:
        p_ms = device_ms(lambda: engine.stencil_temporal_plain(u, spec,
                                                               **kw),
                         reps=3, inner=3)
        s[dname] = dict(row, plain_ms=p_ms, library_ms=None)
        extra = f" plain_ms={p_ms:.6f}"
    print(f"{label:16s} {spec_name:9s} {dname:8s} bitwise  K1 {spec_name} "
          f"kernel_ms={k_ms:.6f} general_ms={g_ms:.6f} (the general K1 at "
          f"32x128){extra} bound_ms={b_ms:.6f} ({b_by}) "
          f"bound_nc_ms={nc_ms:.6f} ({nc_by}, no contraction)")


def time_k4(spec, dname, u, out, policy_ms, p_ms, lib_ms, policy_b_ms,
            peaks, s) -> None:
    """K4 alone on pre-made tap views, beside the whole policy call (the
    views' copies and the kernel) and each one's traffic bound."""
    plan = engine.plan_for(u.shape, u.dtype, spec, "shifted")
    views = engine.shifted_views(u, spec)
    got = engine.launch_shifted_views(plan, views, out)
    torch.cuda.synchronize()
    check(torch.equal(got, engine.stencil_shifted_plain(u, spec)),
          "K4 on pre-made views != its plain version")
    k_ms = device_ms(lambda: engine.launch_shifted_views(plan, views, out))
    b_ms, b_by = shifted_kernel_bound_ms(spec, u, peaks)
    print(f"{'shifted':16s} {'jacobi5':9s} {dname:8s} bitwise  "
          f"kernel_ms={k_ms:.6f} (views pre-made) bound_ms={b_ms:.6f} "
          f"({b_by}: {spec.taps} tap planes read, 1 written) library_ms=null "
          f"(no one call sums separate planes); policy_ms={policy_ms:.6f} "
          f"(copies + kernel) policy_bound_ms={policy_b_ms:.6f} (grid read "
          f"once, interior written once) conv2d_ms={lib_ms:.6f} (the policy "
          f"call's yardstick) plain_ms={p_ms:.6f}")
    s[dname] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None,
                "policy_ms": policy_ms, "policy_bound_ms": policy_b_ms,
                "policy_library_ms": lib_ms}


def tap_sum_unflushed(u: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """One sweep's interior as f32 sums of products that keep subnormals
    (what the kernels computed before they were built with -ftz=true)."""
    r = spec.radius
    c = u.float()
    h, w = c.shape
    acc = None
    for (dy, dx), wt in zip(spec.offsets, spec.weights):
        term = c[r + dy:h - r + dy, r + dx:w - r + dx] * wt
        acc = term if acc is None else acc + term
    return acc


def subnormals(x: torch.Tensor) -> int:
    x = x.float()
    return int(((x != 0) & (x.abs() < F32_TINY)).sum())


def ftz_sass() -> dict[str, int]:
    """f32 multiplies and adds in the built stencil library's SASS, by
    whether they flush (``.FTZ``)."""
    lib = build._target("stencil", build.CSRC)
    tool = next(c for c in ("/usr/local/cuda/bin/cuobjdump", "cuobjdump")
                if c == "cuobjdump" or os.path.exists(c))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {"FMUL.FTZ": 0, "FADD.FTZ": 0, "FMUL": 0, "FADD": 0,
              "FFMA": 0}
    for line in sass.splitlines():
        for op in ("FMUL", "FADD", "FFMA"):
            if f" {op}" in line:
                ftz = ".FTZ" in line.split(op, 1)[1].split()[0]
                counts[op + (".FTZ" if ftz and op != "FFMA" else "")] += 1
    return counts


def phase_subnormals() -> None:
    """K1–K4 on inputs in the subnormal range, bit for bit against their
    plain versions, which flush as XLA does: every multiply and add reads
    subnormal operands as zero and flushes a subnormal result."""
    print(f"== phase 3 (subnormals): K1-K4 vs their flushed plain versions "
          f"on inputs up to 16x the smallest normal f32, {NY + 2}x{NX + 2} "
          f"==")
    sass = ftz_sass()
    print(f"stencil library SASS: {sass}")
    check(sass["FMUL.FTZ"] > 0 and sass["FADD.FTZ"] > 0
          and sass["FMUL"] == 0 and sass["FADD"] == 0,
          f"every f32 multiply and add of csrc/stencil.cu must flush: "
          f"{sass}")
    for spec_name, spec in SPECS.items():
        r = spec.radius
        for dname, dtype in DTYPES.items():
            g = torch.Generator(device="cuda").manual_seed(11)
            shape = (NY + 2 * r, NX + 2 * r)
            mag = torch.rand(shape, generator=g, device="cuda") * 16
            sign = torch.rand(shape, generator=g, device="cuda") < 0.5
            u = (torch.where(sign, -mag, mag) * F32_TINY).to(dtype)
            plain1 = engine.stencil_rowchunk_plain(u, spec)
            kept = tap_sum_unflushed(u, spec).to(dtype)
            moved = int((kept != plain1[r:-r, r:-r]).sum())
            check(moved > 0, f"{spec_name} {dname}: the flush changes no "
                             f"cell; the input does not reach it")
            mask = torch.rand(shape, generator=g, device="cuda") < 0.01
            cases = [(p, {}) for p in ("rowchunk", "dbuf", "shifted")]
            cases += [("temporal", {"t": T}), ("temporal", {"t": T,
                                                           "mask": mask})]
            for policy, kw in cases:
                got = getattr(engine, f"stencil_{policy}")(u, spec, **kw)
                want = getattr(engine, f"stencil_{policy}_plain")(u, spec,
                                                                  **kw)
                torch.cuda.synchronize()
                label = policy + (" masked" if "mask" in kw else "")
                check(torch.equal(got, want),
                      f"subnormal input: {label} {spec_name} {dname} != its "
                      f"flushed plain version")
                inner = got[..., r:-r, r:-r]
                if policy != "temporal":
                    check(subnormals(inner) == 0,
                          f"{label} {spec_name} {dname} kept a subnormal")
            print(f"{spec_name:9s} {dname:8s} K1 (masked and not), K2, K3, "
                  f"K4 bitwise; input subnormal cells {subnormals(u)}, "
                  f"cells the flush moves in one sweep {moved}")


# Phase 14: the Grayskull e150 model. (label, interior rows, interior
# cols, dtype, tilized, policy -> (bm, t)): the paper's grid where the
# model hosts a program (bf16 row-major: one 9218-cell row of 32x32 tiles
# is 289 tiles, 0.59 MB in bf16, 1.18 MB in f32, of a core's 1.5 MiB), and
# every policy in f32 row-major and bf16 tilized at the paper grid's
# height and the widest interior whose programs all fit (1024).
E150 = "grayskull_e150"
SIM_ITERS = 11
SIM_CASES = (
    ("paper grid", NY, NX, "bfloat16", False,
     {"rowchunk": (16, None), "temporal": (4, 4)}),
    ("1024 wide", NY, 1024, "float32", False,
     {p: (32, 8) for p in ("shifted", "rowchunk", "dbuf", "temporal")}),
    ("1024 wide", NY, 1024, "bfloat16", True,
     {p: (32, 8) for p in ("shifted", "rowchunk", "dbuf", "temporal")}),
)


def sim_refusals() -> None:
    """At the paper's grid no policy lowers in f32 row-major or bf16
    tilized on the e150 model: each refusal prints its diagnostic."""
    for dname, tilized in (("float32", False), ("bfloat16", True)):
        for policy in backends.lowerable_policies():
            try:
                backends.lower((NY + 2, NX + 2), dname, jacobi_2d_5pt(),
                               policy, bm=8, t=4, device=E150,
                               tilized=tilized)
            except (backends.LoweringError, engine.PlanError) as e:
                why = next(line for line in str(e).splitlines()
                           if "needs" in line).strip()
                print(f"[{dname} {'tilized' if tilized else 'row-major'}] "
                      f"{policy}: refused: {why}")
                continue
            raise SystemExit(f"chip_smoke FAILED: {policy} {dname} lowered "
                             f"at the paper grid on {E150}")


def phase_grayskull(smi: str, stats) -> None:
    print(f"== phase 14: the Grayskull e150 model on the card: "
          f"backends.simulate(device={E150!r}) of every lowerable policy, "
          f"each grid bit for bit the card's engine.run ==")
    check(backends.sim._smoke(E150, "cuda") == 0, "backends smoke")
    sim_refusals()
    spec = jacobi_2d_5pt()
    for label, ny, nx, dname, tilized, policies in SIM_CASES:
        dtype = DTYPES[dname]
        u0 = make_laplace_problem(ny, nx, dtype=dtype)
        for policy, (bm, t) in policies.items():
            sched = engine.build_schedule(SIM_ITERS, spec=spec,
                                          shape=u0.shape, dtype=dtype,
                                          policy=policy, t=t, device=E150)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracer = obs_trace.Tracer()
            with obs_trace.use_tracer(tracer):
                res = backends.simulate(u0, spec, policy=policy,
                                        iters=SIM_ITERS, t=t, bm=bm,
                                        device=E150, tilized=tilized)
            torch.cuda.synchronize()
            sim_wall = time.perf_counter() - t0
            check(res.programs[0].tilized == tilized,
                  f"{policy} {dname}: tilized {res.programs[0].tilized}")
            spans = [e for e in tracer.events if e.name == "sim.simulate"]
            check(len(spans) == 1 and spans[0].attrs["model_s"]
                  == res.model_time_s and {c.name for c in tracer.counters}
                  == {"sim.core_busy_s", "sim.cb_occupancy"},
                  f"{policy} {dname}: the sim.simulate span and counters")

            def run(policy=policy, t=t, bm=bm):
                return engine.run(u0, spec, policy=policy, iters=SIM_ITERS,
                                  t=t, bm=bm)
            out, counts = counted(run)
            want = {"temporal": sched.fused_blocks} if policy == "temporal" \
                else {policy: SIM_ITERS}
            if sched.remainder:
                want["rowchunk"] = sched.remainder
            check(counts == {k: want.get(k, 0) for k in counts},
                  f"{policy} {dname}: engine.run launched {counts}")
            check(torch.equal(res.grid, out),
                  f"{label} {policy} {dname}: the simulated grid != the "
                  f"card's engine.run")
            check(subnormals(out) == 0, "no subnormal cell at 11 sweeps")
            s = stats[policy].setdefault("grayskull_sim", {
                "launches": 0, "path": "phase 14: engine.run(policy, "
                                       f"iters={SIM_ITERS}), the simulator's "
                                       "twin"})
            s["launches"] += sum(counts.values()) if policy != "temporal" \
                else counts["temporal"]
            if policy == "temporal":
                stats["rowchunk"].setdefault("grayskull_sim", {
                    "launches": 0, "path": "phase 14: the temporal "
                                           "schedule's remainder"})
                stats["rowchunk"]["grayskull_sim"]["launches"] += \
                    counts["rowchunk"]
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
            wall = sorted(walls)[2]
            summ = sim_report.summarize(res)
            card_gpts = ny * nx * SIM_ITERS / wall / 1e9
            print(f"[{label} {ny}x{nx} {dname} "
                  f"{'tilized' if tilized else 'row-major'}] {policy} "
                  f"bm={bm} t={t}: {sched.describe()}; bit for bit the "
                  f"card's engine.run ({counts})")
            print(f"    MODELED {E150}: GPt/s={summ['gpts']:.6f} "
                  f"energy_J={summ['energy_j']:.6f} "
                  f"model_s={summ['model_time_s']:.6e} "
                  f"bytes/pt={summ['bytes_per_point']:.4f} "
                  f"cores={summ['cores_used']}")
            print(f"    measured on {smi}: engine.run wall={wall:.6f}s "
                  f"GPt/s={card_gpts:.3f}; simulator wall on the card "
                  f"{sim_wall:.3f}s (a Python block loop)")
            if policy == "temporal":
                mesh_whatif(u0, spec, policy, bm, t, tilized, res)
    cells = run_sweep(full=True)
    off = [c for c in cells if c.device != "gpu_sm90"]
    counts = {o: sum(c.outcome == o for c in off)
              for o in ("verified", "infeasible", "error")}
    gpu = {o: sum(c.outcome == o for c in cells if c.device == "gpu_sm90")
           for o in ("verified", "infeasible", "error")}
    print(f"run_sweep(full=True): {len(cells)} cells; tpu_v5e, "
          f"grayskull_e150, cpu_ref: {counts}; gpu_sm90: {gpu}")
    check(len(cells) == 720 and counts == {"verified": 540, "infeasible": 0,
                                           "error": 0},
          "the sweep off the GPU must equal the reference's (540 verified)")
    check(gpu == {"verified": 102, "infeasible": 78, "error": 0},
          f"the gpu_sm90 cells must be the pinned ones: {gpu}")


def mesh_whatif(u0, spec, policy, bm, t, tilized, single) -> None:
    """The paper's four-card what-if: the same simulation over a (4,)
    mesh, serial and overlapped bills; the grid must not move."""
    for overlap in (False, True):
        res = backends.simulate(u0, spec, policy=policy, iters=SIM_ITERS,
                                t=t, bm=bm, device=E150, tilized=tilized,
                                mesh_shape=(4,), overlap=overlap)
        check(torch.equal(res.grid, single.grid),
              "the mesh simulation's grid != the single-chip simulation's")
        b = res.exchange_model
        print(f"    MODELED {E150} mesh (4,) overlap={overlap}: "
              f"model_s={res.model_time_s:.6e} (single chip "
              f"{single.model_time_s:.6e}); bill: {b.describe()}")



def plain_schedule(u: torch.Tensor, spec: StencilSpec, sched) -> torch.Tensor:
    for _ in range(sched.fused_blocks):
        u = engine.stencil_temporal_plain(u, spec, t=sched.t)
    for _ in range(sched.remainder):
        u = engine.stencil_rowchunk_plain(u, spec)
    return u


def counted(fn):
    """Run ``fn`` with the launch counters zeroed just before; return its
    result and the counts read just after."""
    engine.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(engine.LAUNCHES)


def phase_main(smi: str, stats) -> None:
    print("== phase 4: main path, engine.run(policy='auto', "
          f"iters={ITERS}) at {NY}x{NX} ==")
    spec = jacobi_2d_5pt()
    for dname in ("bfloat16", "float32"):
        dtype = DTYPES[dname]
        u0 = make_laplace_problem(NY, NX, dtype=dtype)
        sched = engine.build_schedule(ITERS, spec=spec, shape=u0.shape,
                                      dtype=dtype)
        print(f"[{dname}] schedule: {sched.describe()}")
        check((sched.policy, sched.t, sched.fused_blocks, sched.remainder,
               sched.remainder_policy) == ("temporal", T, 125, 3,
                                           "rowchunk"),
              f"schedule {sched}")
        engine.run(u0, policy="auto", iters=ITERS)  # warm the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts = counted(lambda: engine.run(u0, policy="auto",
                                                 iters=ITERS))
        wall = time.perf_counter() - t0
        variants = dict(engine.TEMPORAL_VARIANTS)
        print(f"[{dname}] launches: {counts}; K1 kernels: {variants}")
        check(counts == {"shifted": 0, "rowchunk": 3, "dbuf": 0,
                         "temporal": 125}, f"launch counts {counts}")
        check(variants == {"jacobi5": 125, "laplace9": 0, "radius2": 0,
                           "general": 0},
              f"all 125 K1 launches must be the jacobi5 kernel: {variants}")
        k2 = dict(engine.ROWCHUNK_VARIANTS)
        check(k2 == {"jacobi5": 3, "laplace9": 0, "radius2": 0,
                     "general": 0},
              f"all 3 K2 launches must be the jacobi5 kernel: {k2}")
        if dname == "bfloat16":
            stats["temporal"].update(launches=counts["temporal"],
                                     path="engine.run(auto, iters=1003)")
            stats["rowchunk"].update(launches=counts["rowchunk"],
                                     path="engine.run(auto, iters=1003)")
        check(out.shape == u0.shape and bool(out.float().isfinite().all()),
              "finite output of the grid's shape")
        check(torch.equal(out, plain_schedule(u0, spec, sched)),
              "main path != the same schedule of plain functions")
        ref = engine.run(u0, policy="reference", iters=ITERS)
        ref32 = engine.run(u0.float(), policy="reference", iters=ITERS)
        err = float((out.float() - ref32).abs().max())
        err_same = float((out.float() - ref.float()).abs().max())
        drift = float((ref.float() - ref32).abs().max())
        limit = 1e-4 if dtype == torch.float32 else 5e-2
        print(f"[{dname}] max |err| vs reference in f32: {err:.6e}; vs "
              f"reference in {dname}: {err_same:.6e}; the {dname} "
              f"reference's own drift from f32: {drift:.6e}")
        check(err < limit, f"max |err| vs the f32 reference {err} >= {limit}")
        gpts = NY * NX * ITERS / wall / 1e9
        res = float(engine.residual_for(spec)(out))
        print(f"[{dname}] bitwise == plain schedule; within {limit:g} of "
              f"the f32 reference; residual {res:.6e}")
        print(f"[{dname}] wall={wall:.6f}s GPt/s={gpts:.3f} on {smi}")


def phase_paths(stats) -> None:
    print("== phase 5: step, shifted, run_converged, run_batched ==")
    spec = jacobi_2d_5pt()
    u0 = make_laplace_problem(NY, NX, dtype=torch.bfloat16)
    check(engine.resolve_auto(u0.shape, u0.dtype, spec, iters=1) == "dbuf",
          "auto single step should pick dbuf")
    out, counts = counted(lambda: engine.step(u0, spec))
    print(f"step(auto): launches {counts}")
    check(counts["dbuf"] == 1 and torch.equal(out, apply_stencil(u0, spec)),
          "step(auto) must launch dbuf once and equal the oracle")
    check(engine.DBUF_VARIANTS["jacobi5"] == 1,
          f"step(auto) must run K3's jacobi5 kernel: {engine.DBUF_VARIANTS}")
    stats["dbuf"].update(launches=counts["dbuf"], path="engine.step(auto)")
    out, counts = counted(lambda: engine.run(u0, spec, policy="shifted",
                                             iters=3))
    print(f"run(shifted, iters=3): launches {counts}")
    want = u0
    for _ in range(3):
        want = apply_stencil(want, spec)
    check(counts["shifted"] == 3 and torch.equal(out, want),
          "shifted policy must launch 3 times and equal the oracle")
    stats["shifted"].update(launches=counts["shifted"],
                            path="engine.run(shifted, iters=3)")

    u32 = make_laplace_problem(NY, NX, dtype=torch.float32)
    tol = float(engine.residual_for(spec)(engine.run(u32, iters=400)))
    (cu, n, res), counts = counted(lambda: engine.run_converged(
        u32, spec, tol=tol, max_iters=ITERS))
    print(f"run_converged(tol={tol:.6e}): iters {n}/{ITERS}, residual "
          f"{res:.6e}, launches {counts}")
    check(n % T == 0 and 0 < n <= 400 and res <= tol,
          "run_converged must stop early on a cadence boundary")
    check(torch.equal(cu, engine.run(u32, iters=n)),
          "run_converged result != run(iters=iters_done)")

    lanes = torch.stack([make_laplace_problem(NY, NX, dtype=torch.bfloat16,
                                              left=1.0 - 0.2 * i,
                                              top=0.1 * i)
                         for i in range(4)])
    got, counts = counted(lambda: engine.run_batched(lanes, spec, iters=67))
    print(f"run_batched(B=4, iters=67): launches {counts}")
    check(counts == {"shifted": 0, "rowchunk": 3, "dbuf": 0, "temporal": 8},
          "a batch is one launch per block")
    check(engine.ROWCHUNK_VARIANTS["jacobi5"] == 3,
          f"run_batched's K2 kernel: {engine.ROWCHUNK_VARIANTS}")
    for i in range(4):
        check(torch.equal(got[i], engine.run(lanes[i].clone(), spec,
                                             iters=67)),
              f"batched lane {i} != its solo run")
    print("run_batched: every lane bitwise equal to its solo run")


def flash_bound_ms(q, k, causal: bool, peaks,
                   core: bool = False) -> tuple[float, str]:
    """Least time for attention on these inputs: q, k, v read once and o
    written once, against 4*hd operations for every (query row, key) pair
    the causal mask keeps, at the dense bf16 tensor-core rate for bf16;
    for f32 the work as the kernel does it, three TF32 products (split
    TF32) at the dense TF32 rate, or with ``core`` the function on the
    CUDA cores at their f32 rate (the route the kernel replaced)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    ops = 4 * hd * pairs * b * h
    if q.dtype == torch.bfloat16:
        rate = peaks.bf16
    elif core:
        rate = peaks.f32
    else:
        ops, rate = 3 * ops, peaks.tf32
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    b_ms, o_ms = nbytes / peaks.bw * 1e3, ops / rate * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def phase_flash(peaks, stats) -> None:
    print("== phase 6: K8 flash attention vs its plain version (bf16 on "
          "the wgmma kernel, f32 on the split-TF32 kernel) ==")
    s = stats.setdefault("flash", {d: {"max_abs_err": 0.0} for d in DTYPES})
    for key in FLASH_TIMED.values():
        s[key] = {d: {} for d in DTYPES}
    for b, sq, h, kh, hd, causal, blk in FLASH_SHAPES:
        for dname, dtype in DTYPES.items():
            route = FLASH_ROUTES[dname][0]
            g = torch.Generator(device="cuda").manual_seed(sq + h)
            q, k, v = (torch.randn(shape, generator=g, device="cuda"
                                   ).to(dtype)
                       for shape in ((b, sq, h, hd), (b, sq, kh, hd),
                                     (b, sq, kh, hd)))
            flash.reset_launch_counts()
            got = flash.flash_attention_local(q, k, v, causal=causal,
                                              bq=blk, bk=blk)
            launched = dict(flash.LAUNCHES)
            want = flash.flash_attention_local_plain(q, k, v, causal=causal,
                                                     bq=blk, bk=blk)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dname]
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            worst = float((diff - tol * want.float().abs()).max())
            label = f"B={b} S={sq} H={h} K={kh} hd={hd} causal={causal}"
            check(launched == {"flash_attention": 1,
                               "flash_attention_wgmma": int(route == "wgmma"),
                               "flash_attention_tf32": int(route != "wgmma")},
                  f"K8 {label} {dname} must launch the {route} kernel once: "
                  f"{launched}")
            check(got.shape == q.shape and got.dtype == dtype
                  and bool(got.float().isfinite().all()) and worst <= tol,
                  f"K8 {label} {dname}: max |err| {err} over rtol=atol={tol}")
            s[dname]["max_abs_err"] = max(s[dname]["max_abs_err"], err)
            if sq != PROMPT:
                print(f"K8 {label:42s} {dname:8s} {route:9s} "
                      f"max|err|={err:.3e} (tol {tol:g})")
                continue
            k_ms = device_ms(lambda: flash.flash_attention_local(
                q, k, v, causal=causal), reps=5, inner=5)
            p_ms = device_ms(lambda: flash.flash_attention_local_plain(
                q, k, v, causal=causal), reps=3, inner=2)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), reps=5,
                inner=5)
            b_ms, b_by = flash_bound_ms(q, k, causal, peaks)
            timed = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms)
            extra = ""
            if dname == "float32":  # the work as done, and on the CUDA cores
                c_ms, c_by = flash_bound_ms(q, k, causal, peaks, core=True)
                timed.update(core_bound_ms=c_ms, core_bound_by=c_by)
                extra = (f" kernel/sdpa={k_ms / lib_ms:.3f} share of the "
                         f"tf32x3 bound {b_ms / k_ms:.1%}, of the f32 "
                         f"CUDA-core bound {c_ms:.6f} ({c_by}) "
                         f"{c_ms / k_ms:.1%}")
            print(f"K8 {label:42s} {dname:8s} {route:9s} max|err|={err:.3e} "
                  f"(tol {tol:g}) kernel_ms={k_ms:.6f} bound_ms={b_ms:.6f} "
                  f"({b_by}) sdpa_ms={lib_ms:.6f} plain_ms={p_ms:.6f}{extra}")
            s[FLASH_TIMED[hd]][dname].update(shape=label, max_abs_err=err,
                                             **timed)
            if hd == 128:
                s[dname].update(timed)


def wall_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn()`` ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def time_serving(eng, toks, cache, done, requests, first: float,
                 peak: float, smi: str) -> None:
    """Time a serving path's prefill and decode step (wall, and kernel time
    from ``torch.profiler``), list prefill's kernels with the most device
    time, and check that a second greedy run gives the same tokens."""
    step = torch.from_numpy(np.asarray([[r.generated[0]] for r in done],
                                       np.int64)).cuda()
    prefill = wall_ms(lambda: eng._prefill(toks), reps=3)
    decode = wall_ms(lambda: [eng._decode(cache, step) for _ in range(16)],
                     reps=3) / 16
    prefill_dev, prefill_n = kernel_ms(lambda: eng._prefill(toks))
    decode_dev, decode_n = kernel_ms(lambda: eng._decode(cache, step))
    print(f"device kernels (torch.profiler): prefill {prefill_dev:.3f} ms "
          f"in {prefill_n} kernels (busy {prefill_dev / prefill:.1%} of its "
          f"wall), decode step {decode_dev:.3f} ms in {decode_n} kernels "
          f"(busy {decode_dev / decode:.1%} of its wall)")
    print("prefill's kernels with the most device time:")
    for name, ms, n in top_kernels(lambda: eng._prefill(toks)):
        print(f"  {ms:10.3f} ms {n:5d}x  {name[:100]}")
    t0 = time.perf_counter()
    again = eng.generate(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    new = sum(len(r.generated) for r in again)
    check([r.generated for r in again] == [r.generated for r in done],
          "a second greedy run must give the same tokens")
    print(f"prefill_ms={prefill:.3f} (wall, {WAVE}x{PROMPT} tokens) "
          f"decode_ms_per_step={decode:.3f} (wall, {WAVE} tokens a step) "
          f"generate: first run {first:.3f}s (includes the one-time bf16 "
          f"weight casts), second {wall:.3f}s = {new / wall:.1f} tok/s "
          f"({new} new tokens); peak memory {peak:.2f} GiB; on {smi}")


def phase_serve(smi: str, stats) -> None:
    cfg = dataclasses.replace(configs.get_config("qwen2.5-3b"),
                              attn_impl="flash")
    print(f"== phase 7: LM serving, {cfg.name} at full width ({cfg.n_layers}"
          f" layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"vocab {cfg.vocab_size}), attn_impl=flash, {WAVE} x {PROMPT} "
          f"tokens + {NEW} new ==")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"random init of {sum(p.numel() for p in model.parameters())} "
          f"params in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(WAVE, PROMPT),
                           dtype=np.int32)
    eng = ServeEngine(model, batch_size=WAVE, max_len=PROMPT + NEW + 8)

    def requests():
        return [Request(prompt=p, max_new_tokens=NEW) for p in prompts]

    torch.cuda.reset_peak_memory_stats()
    engine.reset_launch_counts()
    flash.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.generate(requests())
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = {**engine.LAUNCHES, **flash.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"launches: {counts}")
    check(counts["flash_attention"] == cfg.n_layers
          and counts["flash_attention_wgmma"] == cfg.n_layers
          and sum(engine.LAUNCHES.values()) == 0,
          f"one prefill wave must launch K8 once a layer ({cfg.n_layers}), "
          f"each on the tensor-core kernel")
    stats["flash"].update(launches=counts["flash_attention_wgmma"],
                          path="ServeEngine.generate(qwen2.5-3b, flash)")
    for i, r in enumerate(done):
        check(len(r.generated) == NEW
              and all(0 <= t < cfg.padded_vocab for t in r.generated),
              f"request {i}: {len(r.generated)} tokens, ids {r.generated}")
    print(f"req0 -> {done[0].generated[:8]} ...; every request got {NEW} "
          f"tokens in [0, {cfg.padded_vocab})")

    toks = torch.from_numpy(prompts.astype(np.int64)).cuda()
    got, cache = eng._prefill(toks)
    ref = ServeEngine(model.with_config(dataclasses.replace(
        cfg, attn_impl="jnp")), batch_size=WAVE, max_len=eng.max_len)
    want, _ = ref._prefill(toks)
    diff = (got - want).abs()
    err = float(diff.max())
    worst = float((diff - 5e-2 * want.abs()).max())
    print(f"prefill logits, flash vs jnp: max |diff| {err:.6e}, largest "
          f"excess over rtol*|jnp| {worst:.6e} (atol 8e-2), logit range "
          f"[{float(want.min()):.3f}, {float(want.max()):.3f}]")
    check(bool(got.isfinite().all()) and worst <= 8e-2,
          f"flash prefill logits off the jnp path: max |diff| {err}")

    reset_all_launches()
    exact, _ = ServeEngine(model.with_config(dataclasses.replace(
        cfg, dtype=torch.float32)), batch_size=WAVE,
        max_len=eng.max_len)._prefill(toks)
    torch.cuda.synchronize()
    f32_counts = dict(flash.LAUNCHES)
    print(f"the f32 prefill's K8 launches: {f32_counts}")
    check(f32_counts == {"flash_attention": cfg.n_layers,
                         "flash_attention_wgmma": 0,
                         "flash_attention_tf32": cfg.n_layers}
          and sum(all_launches().values()) == 2 * cfg.n_layers,
          f"the f32 prefill must launch K8 once a layer ({cfg.n_layers}), "
          f"each on the split-TF32 kernel, and no other kernel")
    stats["flash"]["float32"].update(
        launches=cfg.n_layers,
        path="ServeEngine._prefill(qwen2.5-3b, flash, float32)")
    print(f"the same prefill in f32 compute, max |diff| of flash (bf16) "
          f"{float((got - exact).abs().max()):.6e}, of jnp (bf16) "
          f"{float((want - exact).abs().max()):.6e}")

    time_serving(eng, toks, cache, done, requests, first, peak, smi)


def conv_bound_ms(x, w, b, peaks) -> tuple[float, str]:
    """Least time for the conv: x, w, b read once and out written once,
    against 2K-1 f32 operations an output (one more with a bias)."""
    bw, flops = peaks.bw, peaks.f32
    nbytes = (2 * x.numel() + w.numel()
              + (0 if b is None else b.numel())) * x.element_size()
    ops = (2 * w.shape[0] - 1 + (b is not None)) * x.numel()
    b_ms, o_ms = nbytes / bw * 1e3, ops / flops * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def phase_conv(peaks, stats) -> None:
    print("== phase 8: K7 depthwise causal conv vs its plain version, bit "
          "for bit ==")
    s = stats.setdefault("conv1d", {"max_abs_err": 0.0})
    for bsz, length, d, k, bl in CONV_SHAPES:
        for dname, dtype in DTYPES.items():
            g = torch.Generator(device="cuda").manual_seed(length + d)
            x = torch.randn((bsz, length, d), generator=g,
                            device="cuda").to(dtype)
            w = (torch.randn((k, d), generator=g, device="cuda")
                 * 0.5).to(dtype)
            b = torch.randn((d,), generator=g, device="cuda").to(dtype)
            label = f"B={bsz} L={length} D={d} K={k}"
            for bias in (None, b):  # the biased result stays in ``got``
                got = conv.conv1d_depthwise_causal(x, w, bias, bl=bl)
                want = conv.conv1d_depthwise_causal_plain(x, w, bias)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tag = "bias" if bias is not None else "no bias"
                check(got.shape == x.shape and got.dtype == dtype
                      and torch.equal(got, want),
                      f"K7 {label} {dname} {tag}: max |err| {err}")
                s["max_abs_err"] = max(s["max_abs_err"], err)
                print(f"K7 {label:26s} {dname:8s} {tag:7s} bitwise")
            if length != PROMPT:
                continue
            k_ms = device_ms(lambda: conv.conv1d_depthwise_causal(x, w, b,
                                                                  bl=bl))
            p_ms = device_ms(lambda: conv.conv1d_depthwise_causal_plain(
                x, w, b), reps=5, inner=3)
            # cuDNN's depthwise conv on a (B, D, L+K-1) layout made once.
            xt = F.pad(x.transpose(1, 2), (k - 1, 0)).contiguous()
            wt = w.t().contiguous()[:, None, :]
            lib = F.conv1d(xt, wt, b, groups=d)
            lib_err = float((lib.transpose(1, 2).float()
                             - got.float()).abs().max())
            lib_ms = device_ms(lambda: F.conv1d(xt, wt, b, groups=d))
            b_ms, b_by = conv_bound_ms(x, w, b, peaks)
            print(f"K7 {label:26s} {dname:8s} kernel_ms={k_ms:.6f} "
                  f"plain_ms={p_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
                  f"conv1d_ms={lib_ms:.6f} (its max |diff| {lib_err:.3e})")
            s[dname] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms}


def phase_ssm(smi: str, stats) -> None:
    cfg = dataclasses.replace(configs.get_config("mamba2-2.7b"),
                              ssm_conv_impl="pallas")
    print(f"== phase 9: SSM serving, {cfg.name} at full width ({cfg.n_layers}"
          f" layers, d {cfg.d_model}, {cfg.ssm_heads} SSD heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, vocab "
          f"{cfg.vocab_size}), ssm_conv_impl=pallas, {WAVE} x {PROMPT} "
          f"tokens + {NEW} new ==")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"random init of {sum(p.numel() for p in model.parameters())} "
          f"params in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(WAVE, PROMPT),
                           dtype=np.int32)
    eng = ServeEngine(model, batch_size=WAVE, max_len=PROMPT + NEW + 8)

    def requests():
        return [Request(prompt=p, max_new_tokens=NEW) for p in prompts]

    torch.cuda.reset_peak_memory_stats()
    engine.reset_launch_counts()
    flash.reset_launch_counts()
    conv.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.generate(requests())
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = {**engine.LAUNCHES, **flash.LAUNCHES, **conv.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"launches: {counts}")
    check(counts["conv1d"] == cfg.n_layers
          and sum(counts.values()) == cfg.n_layers,
          f"one prefill wave must launch K7 once a layer ({cfg.n_layers}) "
          f"and no other kernel")
    stats["conv1d"].update(launches=counts["conv1d"],
                           path="ServeEngine.generate(mamba2-2.7b, pallas)")
    for i, r in enumerate(done):
        check(len(r.generated) == NEW
              and all(0 <= t < cfg.padded_vocab for t in r.generated),
              f"request {i}: {len(r.generated)} tokens, ids {r.generated}")
    print(f"req0 -> {done[0].generated[:8]} ...; every request got {NEW} "
          f"tokens in [0, {cfg.padded_vocab})")

    toks = torch.from_numpy(prompts.astype(np.int64)).cuda()
    got, cache = eng._prefill(toks)
    plain = ServeEngine(model.with_config(dataclasses.replace(
        cfg, ssm_conv_impl="jnp")), batch_size=WAVE, max_len=eng.max_len)
    want, _ = plain._prefill(toks)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"prefill logits, K7 vs the plain conv: max |diff| {err:.6e}, "
          f"logit range [{float(want.min()):.3f}, {float(want.max()):.3f}]")
    check(bool(got.isfinite().all()) and torch.equal(got, want),
          f"K7 prefill logits differ from the plain-conv route: {err}")
    exact, _ = ServeEngine(model.with_config(dataclasses.replace(
        cfg, dtype=torch.float32)), batch_size=WAVE,
        max_len=eng.max_len)._prefill(toks)
    print(f"the same prefill in f32 compute: max |diff| of bf16 "
          f"{float((got - exact).abs().max()):.6e}")
    del exact, want, plain

    time_serving(eng, toks, cache, done, requests, first, peak, smi)


def all_launches() -> dict:
    return {**engine.LAUNCHES, **flash.LAUNCHES, **conv.LAUNCHES,
            **stream.LAUNCHES, **components.LAUNCHES}


def reset_all_launches() -> None:
    for mod in (engine, flash, conv, stream, components):
        mod.reset_launch_counts()


def excess(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """max |got - want| and its largest excess over 5e-2 * |want|."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), float((diff - 5e-2 * want.float().abs()).max())


@torch.no_grad()
def shared_block_gaps(model, ref, walk, toks: torch.Tensor) -> list:
    """Hold each application of ``model``'s shared block against ``ref``'s
    (the same weights on another route) on ``walk``'s stream (one of the
    two): the embeddings, then each group's output. Returns (max |diff|,
    largest excess over 5e-2 * |ref|) per application."""
    cfg = walk.cfg
    emb = basic.embed(walk.embedding, toks, cfg)
    b, s = toks.shape
    pos = torch.arange(s, device=toks.device).expand(b, s)
    x, gaps = emb, []
    for group in walk.groups:
        want = ref.shared_block(x, emb, pos, None)
        got = model.shared_block(x, emb, pos, None)
        gaps.append(excess(got, want))
        x = got if walk is model else want
        del got, want
        for layer in group:
            x = walk.mamba_layer(layer, x)
    return gaps


def phase_hybrid(smi: str, stats) -> None:
    cfg = dataclasses.replace(configs.get_config("zamba2-7b"),
                              attn_impl="flash", ssm_conv_impl="pallas")
    groups = cfg.n_layers // cfg.hybrid_period
    print(f"== phase 11: hybrid serving, {cfg.name} at full width and depth "
          f"({cfg.n_layers} mamba layers in {groups} groups of "
          f"{cfg.hybrid_period} behind one shared block + "
          f"{cfg.n_layers % cfg.hybrid_period}, d {cfg.d_model}, "
          f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, {cfg.n_heads}/{cfg.n_kv_heads} heads of hd "
          f"{cfg.hd}, vocab {cfg.vocab_size}), attn_impl=flash, "
          f"ssm_conv_impl=pallas, {WAVE} x {PROMPT} tokens + {NEW} new ==")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"random init of {sum(p.numel() for p in model.parameters())} "
          f"params in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, size=(WAVE, PROMPT),
                           dtype=np.int32)
    eng = ServeEngine(model, batch_size=WAVE, max_len=PROMPT + NEW + 8)

    def requests():
        return [Request(prompt=p, max_new_tokens=NEW) for p in prompts]

    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    done = eng.generate(requests())
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = all_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"launches: {counts}")
    want_counts = {"flash_attention": groups,
                   "flash_attention_wgmma": groups, "conv1d": cfg.n_layers}
    check(counts == {k: want_counts.get(k, 0) for k in counts},
          f"one prefill wave must launch K8 once a group ({groups}), each on "
          f"the tensor-core kernel, K7 once a mamba layer ({cfg.n_layers}), "
          f"and no other kernel")
    path = "ServeEngine.generate(zamba2-7b, flash, pallas)"
    stats["flash"]["hd112"]["bfloat16"].update(launches=groups, path=path)
    stats["conv1d"].setdefault("paths", {})[path] = cfg.n_layers
    for i, r in enumerate(done):
        check(len(r.generated) == NEW
              and all(0 <= t < cfg.padded_vocab for t in r.generated),
              f"request {i}: {len(r.generated)} tokens, ids {r.generated}")
    print(f"req0 -> {done[0].generated[:8]} ...; every request got {NEW} "
          f"tokens in [0, {cfg.padded_vocab})")

    toks = torch.from_numpy(prompts.astype(np.int64)).cuda()

    def prefill(knobs):
        twin = model.with_config(dataclasses.replace(cfg, **knobs))
        return ServeEngine(twin, batch_size=WAVE,
                           max_len=eng.max_len)._prefill(toks)[0]

    got, cache = eng._prefill(toks)
    plain = prefill({"ssm_conv_impl": "jnp"})
    torch.cuda.synchronize()
    check(bool(got.isfinite().all()) and torch.equal(got, plain),
          f"K7 prefill logits differ from the plain-conv route: "
          f"{float((got - plain).abs().max())}")
    print("prefill logits, K7 vs the plain conv (K8 kept): bit for bit")
    del plain

    # K8 at each application of the shared block, on each route's own
    # stream (the serving path's, and the jnp route's): the JAX package's
    # bound, rtol 5e-2 and atol 8e-2.
    jnp_model = model.with_config(dataclasses.replace(cfg, attn_impl="jnp"))
    for name, walk in (("flash", model), ("jnp", jnp_model)):
        gaps = shared_block_gaps(model, jnp_model, walk, toks)
        print(f"each application of the shared block, flash vs jnp on the "
              f"{name} route's stream (max |diff| / largest excess over "
              f"5e-2*|jnp|): " + "; ".join(f"{g}: {e:.4e} / {w:.4e}"
                                          for g, (e, w) in enumerate(gaps)))
        check(all(w <= 8e-2 for _, w in gaps),
              f"the shared block through K8 off the jnp path on the {name} "
              f"route's stream: {gaps}")
    del jnp_model

    # The whole model, flash vs jnp, in f32 compute (K8's split-TF32 route).
    reset_all_launches()
    exact = prefill({"dtype": torch.float32})
    torch.cuda.synchronize()
    f32_counts = dict(flash.LAUNCHES)
    print(f"the f32 prefill's K8 launches: {f32_counts}")
    check(f32_counts == {"flash_attention": groups,
                         "flash_attention_wgmma": 0,
                         "flash_attention_tf32": groups},
          f"the f32 prefill must launch K8 once a group ({groups}), each "
          f"on the split-TF32 kernel")
    stats["flash"]["hd112"]["float32"].update(
        launches=groups,
        path="ServeEngine._prefill(zamba2-7b, flash, pallas, float32)")
    exact_jnp = prefill({"dtype": torch.float32, "attn_impl": "jnp"})
    err, worst = excess(exact, exact_jnp)
    print(f"prefill logits in f32 compute, flash vs jnp: max |diff| "
          f"{err:.6e}, largest excess over rtol*|jnp| {worst:.6e} (atol "
          f"8e-2), logit range [{float(exact_jnp.min()):.3f}, "
          f"{float(exact_jnp.max()):.3f}]")
    check(bool(exact.isfinite().all()) and worst <= 8e-2,
          f"f32 flash prefill logits off the jnp path: max |diff| {err}")
    want = prefill({"attn_impl": "jnp"})
    to_f32 = [float((x - exact_jnp).abs().max()) for x in (got, want)]
    del exact, exact_jnp
    time_serving(eng, toks, cache, done, requests, first, peak, smi)

    # The whole bf16 prefill, flash vs jnp, is printed and not held to the
    # JAX package's bound: on these weights the 81 SSD layers grow any
    # one-ulp bf16 difference in the stream to O(1) at the logits, so two
    # right routes differ about as much as either differs from f32 compute
    # and the comparison cannot tell a right K8 from a wrong one. K8 is
    # held above at every application, and the whole model in f32.
    err, worst = excess(got, want)
    print(f"prefill logits in bf16, flash vs jnp (not a gate): max |diff| "
          f"{err:.6e}, largest excess over rtol*|jnp| {worst:.6e} (atol "
          f"8e-2); against the f32 jnp logits, flash (bf16) {to_f32[0]:.6e}, "
          f"jnp (bf16) {to_f32[1]:.6e}")
    check(bool(got.isfinite().all()) and bool(want.isfinite().all()),
          "bf16 prefill logits must be finite")

def stream_cases():
    """(wrapper, shape, kwargs, dtypes): the JAX test-like shapes, then
    the tables' shapes."""
    ints, floats = (torch.int32, torch.bfloat16), (torch.float32,
                                                    torch.bfloat16)
    every = (torch.int32, torch.float32, torch.bfloat16)
    side = access.SIDE
    cases = [("stream_copy", (128, 256), {"bm": 16, "bn": 256}, every),
             ("stream_copy", (96, 258), {"bm": 32, "bn": 129}, every),
             ("stream_copy", (30, 45), {"bm": 3, "bn": 5}, every)]
    cases += [("stream_copy", (side, side), {"bm": 256, "bn": bn}, ints)
              for bn in access.COPY_BN]
    cases += [("stream_copy", (side, side), {"bm": bm, "bn": bn}, ints)
              for bm, bn in ((64, side), (256, 256), (1024, 64), (1024, 8))]
    cases += [("stream_copy", (access.layout_rows(w), w),
               {"bm": 128, "bn": w}, floats) for w, _ in access.WIDTHS]
    for sync in (False, True):
        cases += [("stream_copy_rowdma", (128, 256), {"bm": 16, "sync": sync},
                   every),
                  ("stream_copy_rowdma", (96, 40), {"bm": 32, "sync": sync},
                   every),
                  ("stream_copy_rowdma", (side, side),
                   {"bm": 64, "sync": sync}, every)]
    for factor in (1, 3, 7, 32):
        cases += [("stream_replicated", (128, 256),
                   {"bm": 16, "factor": factor}, every),
                  ("stream_replicated", (96, 258),
                   {"bm": 32, "factor": factor}, every)]
    cases += [("stream_replicated", (side, side), {"bm": 128, "factor": f},
               every if f in (1, 32) else (torch.float32,))
              for f in access.FACTORS]
    for op in ("dma_only", "compute_only"):
        cases += [(op, (100, 130), {"bm": 16}, floats),
                  (op, (514, 514), {"bm": 64}, floats),
                  (op, (1026, 9218), {"bm": 64}, floats)]
    return cases


def stream_fn(name: str):
    mod = components if name in components.LAUNCHES else stream
    return getattr(mod, name), getattr(mod, f"{name}_plain")


# The L2 probe's layouts, (loads in flight a thread, tiles an SM, passes):
# each buffer at most half the L2, its rate read with the sum checked.
PROBE_LAYOUTS = [(u, tiles, p) for u, tiles in ((8, 3), (8, 6), (4, 6),
                                                (4, 8), (4, 12))
                 for p in (64, 128)]


def l2_probe_rates(smi: str) -> dict[str, float]:
    """Bytes/s at which the L2 serves K5c's volatile 16-byte loads, for
    each of the probe's layouts: a buffer of whole tiles an SM re-read
    ``passes`` times a launch, its sum checked against the plain
    version. Returns ``{layout: rate}``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(12)
    rates = {}
    for unroll, tiles, passes in PROBE_LAYOUTS:
        x = torch.randint(-2**31, 2**31 - 1,
                          (tiles * sms * stream.probe_tile(unroll) // 4,),
                          generator=g, dtype=torch.int32, device="cuda")
        got = stream.l2_read_probe(x, passes=passes, unroll=unroll)
        torch.cuda.synchronize()
        check(torch.equal(got.cpu(),
                          stream.l2_read_probe_plain(x, passes=passes)),
              f"the L2 probe's sum != its plain version ({unroll}, {tiles}, "
              f"{passes})")
        ms = device_ms(lambda: stream.l2_read_probe(x, passes=passes,
                                                    unroll=unroll))
        label = (f"unroll {unroll}, {tiles} tiles an SM "
                 f"({x.numel() * 4 / 2**20:.3f} MiB), {passes} passes")
        rates[label] = passes * x.numel() * 4 / ms * 1e3
        print(f"L2 probe, {label}: {rates[label] / 1e12:.4f} TB/s "
              f"({ms:.6f} ms, sum checked) on {smi}")
    return rates


def replicated_bound_ms(x: torch.Tensor, factor: int, bw: float,
                        l2: float) -> float:
    """K5c's least time: HBM serves the first read and the write, the L2
    each of the factor reads and the write, at ``l2`` bytes/s."""
    nbytes = x.numel() * x.element_size()
    return max(2 * nbytes / bw, (factor + 1) * nbytes / l2) * 1e3


def phase_stream(peaks, stats, smi: str) -> None:
    print("== phase 10: the memory-access study, K5a-c and K6a-b vs their "
          "plain versions, bit for bit, then launch.access on Tables II-VI "
          "==")
    bw, flops = peaks.bw, peaks.f32
    for name in STREAM:
        stats[name] = {"max_abs_err": 0.0}
    for seed, (name, shape, kw, dtypes) in enumerate(stream_cases()):
        fn, plain = stream_fn(name)
        for dtype in dtypes:
            g = torch.Generator(device="cuda").manual_seed(seed)
            x = (torch.randn(shape, generator=g, device="cuda")
                 * 3000).to(dtype)
            got, want = fn(x, **kw), plain(x, **kw)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            check(got.dtype == dtype and torch.equal(got, want),
                  f"{name} {shape} {kw} {dtype}: max |err| {err}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        print(f"{name:18s} {str(shape):14s} {str(kw):28s} "
              f"{','.join(str(d)[6:] for d in dtypes)} bitwise")

    side = access.SIDE
    ramp = torch.arange(side * side, dtype=torch.int32,
                        device="cuda").reshape(side, side)
    grid = make_laplace_problem(NY, NX, dtype=torch.bfloat16)
    mains = {"stream_copy": (ramp, {"bm": 256, "bn": side}),
             "stream_copy_rowdma": (ramp, {"bm": 64, "sync": False}),
             "stream_replicated": (ramp.float(), {"bm": 128, "factor": 32}),
             "dma_only": (grid, {"bm": 64}),
             "compute_only": (grid, {"bm": 64})}
    # K5c at each factor of Table V, then the L2's rate: the highest read
    # rate seen in this run, the probe's best layout or K5c's own (each of
    # its reads and its write go through the L2, so no L2 is slower than
    # (factor + 1) bytes over its time); every share is then at most 1.
    rep = mains["stream_replicated"][0]
    k5c_ms = {f: device_ms(lambda: stream.stream_replicated(rep, bm=128,
                                                            factor=f))
              for f in access.FACTORS}
    probes = l2_probe_rates(smi)
    best = max(probes, key=probes.get)
    own = {f: (f + 1) * rep.numel() * rep.element_size() / ms * 1e3
           for f, ms in k5c_ms.items()}
    fown = max(own, key=own.get)
    l2 = max(probes[best], own[fown])
    print(f"L2 read rate: {l2 / 1e12:.4f} TB/s, the higher of the probe's "
          f"best ({best}: {probes[best] / 1e12:.4f} TB/s) and K5c's own "
          f"(factor + 1) bytes / time (x{fown}: {own[fown] / 1e12:.4f} "
          f"TB/s) on {smi}")
    for name, (x, kw) in mains.items():
        fn, plain = stream_fn(name)
        out = fn(x, **kw)
        # each input byte the function needs read once, each output written
        # once (dma_only needs only the interior it writes)
        nbytes = ((2 if name == "dma_only" else 1) * out.numel()
                  + (0 if name == "dma_only" else x.numel())) * x.element_size()
        ops = {"stream_replicated": kw.get("factor", 0) * x.numel(),
               "compute_only": 4 * x.numel()}.get(name, 0)
        b_ms, o_ms = nbytes / bw * 1e3, ops / flops * 1e3
        if name == "stream_replicated":
            # K5c's function is `factor` fetches of every block: HBM serves
            # the first read and the write, the L2 every access
            b_ms = replicated_bound_ms(x, kw["factor"], bw, l2)
        k_ms = (k5c_ms[kw["factor"]] if name == "stream_replicated"
                else device_ms(lambda: fn(x, **kw)))
        p_ms = device_ms(lambda: plain(x, **kw), reps=5, inner=3)
        src = x[1:-1, 1:-1] if name == "dma_only" else x
        lib_ms = (None if name in ("stream_replicated", "compute_only")
                  else device_ms(lambda: out.copy_(src)))
        s = stats[name]
        s.update(ms=k_ms, plain_ms=p_ms, bound_ms=max(b_ms, o_ms),
                 bound_by="bytes" if b_ms >= o_ms else "operations",
                 library_ms=lib_ms)
        extra = ""
        if name == "stream_replicated":
            # the old bound (bytes once at HBM's rate), and what the factor
            # reads and the write would take from HBM, as the TPU moves them
            s["bytes_once_ms"] = nbytes / bw * 1e3
            s["traffic_ms"] = ((kw["factor"] + 1) * x.numel()
                               * x.element_size() / bw * 1e3)
            s["l2_tbs"] = l2 / 1e12
            s["l2_probe_tbs"] = probes[best] / 1e12
            s["k5c_l2_tbs"] = own[fown] / 1e12
            extra = (f" (L2-priced: max(2 bytes / HBM, (factor + 1) bytes / "
                     f"L2 at {l2 / 1e12:.4f} TB/s)) bytes_once_ms="
                     f"{s['bytes_once_ms']:.6f} hbm_traffic_ms="
                     f"{s['traffic_ms']:.6f}")
        print(f"{STREAM[name][0]} {name:18s} {STREAM[name][2]}: "
              f"kernel_ms={k_ms:.6f} plain_ms={p_ms:.6f} "
              f"bound_ms={s['bound_ms']:.6f} ({s['bound_by']}){extra} "
              f"copy_ms={'null' if lib_ms is None else f'{lib_ms:.6f}'}")
    shares = {}
    for factor, ms in k5c_ms.items():
        shares[factor] = {"ms": ms, "bound_ms": replicated_bound_ms(
            rep, factor, bw, l2)}
        print(f"K5c x{factor}: kernel_ms={ms:.6f} bound_ms="
              f"{shares[factor]['bound_ms']:.6f} share "
              f"{shares[factor]['bound_ms'] / ms:.1%} (L2 {l2 / 1e12:.4f} "
              f"TB/s, HBM {bw / 1e12:.2f} TB/s) on {smi}")
        # (at the factor that sets the L2's rate the two are equal but
        # for the last bit of the division and product)
        check(shares[factor]["bound_ms"] <= ms * (1 + 1e-12),
              f"K5c x{factor} ran under its bound: the bound is wrong")
    stats["stream_replicated"]["factors"] = shares
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = stream.copy_split(side, side, 256, side, sms)
    stats["stream_copy"]["split"] = split
    print(f"K5a at bm=256 bn={side}: {side // 256} tiles on {sms} SMs, "
          f"each split over {split} blocks ({side // 256 * split} blocks)")
    s = stats["stream_copy_rowdma"]
    plan = stream.rowdma_plan(side * 4, 64, False)
    s["sync_ms"] = device_ms(lambda: stream.stream_copy_rowdma(
        ramp, bm=64, sync=True))
    s["split"] = plan.split
    print(f"K5b at bm=64: sync=False {s['ms']:.6f} ms, "
          f"{s['ms'] / s['library_ms']:.4f}x copy_ ({s['library_ms']:.6f}), "
          f"{s['bound_ms'] / s['ms']:.1%} of its bound, each bm-row block "
          f"over {plan.split} blocks of one row ({side // 64 * plan.split} "
          f"blocks); sync=True {s['sync_ms']:.6f} ms, "
          f"{s['sync_ms'] / s['ms']:.3f}x sync=False (one row in flight a "
          f"bm-row block)")
    del ramp, grid, mains

    stream.reset_launch_counts()
    components.reset_launch_counts()
    rows = {t: access.table_rows(t, "cuda") for t in sorted(access.TABLES)}
    torch.cuda.synchronize()
    counts = {**stream.LAUNCHES, **components.LAUNCHES}
    print(f"launch.access launches: {counts}")
    print("name,us_per_call,derived")
    for t, lines in rows.items():
        print(f"# {access.TITLES[t]}")
        for line in lines:
            print(line)
            name, us, _ = line.split(",")
            # The paper's rows and the simulator's modeled rows carry no
            # time; every measured row must.
            check(name.startswith(("paper_", "sim_")) or float(us) > 0,
                  f"table {t} row {name} measured no time")
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched by launch.access")
        stats[name].update(launches=n, path="launch.access tables II-VI")


# (name, interior rows, interior cols, dtype, requests): phase 12's
# buckets, modelled on benchmarks/bench_serve.py's mix at the paper's size.
SERVE_BUCKETS = [("f32 1024x9216", 1024, 9216, torch.float32, 6),
                 ("f32 2048x4608", 2048, 4608, torch.float32, 6),
                 ("bf16 1024x9216", 1024, 9216, torch.bfloat16, 2)]
SERVE_ITERS, SERVE_SLOTS, SERVE_SUPERBLOCK = 1000, 4, 4


def residual_curve(u0: torch.Tensor, blocks: int) -> list[float]:
    """The residual after each block of T sweeps of one solo solve."""
    u, curve = u0, []
    for _ in range(blocks):
        u = engine.run(u, policy="temporal", iters=T, t=T)
        curve.append(float(engine.residual_for()(u)))
    return curve


def spread_tols(curve: list[float], n: int) -> list[tuple[int, float]]:
    """``n`` (blocks, tol) pairs: blocks spread from the 12th (or the first
    low of a curve that stops falling before it) to the first whose
    residual is a tenth of its, each a new low of the curve,
    and each tol halfway between that low and the lowest residual before
    it, so a request with it converges at exactly that many blocks."""
    lows = [b for b in range(1, len(curve))
            if curve[b] < min(curve[:b])]
    check(bool(lows), "the residual curve never falls")
    b0 = min((b for b in lows if b >= 11), default=lows[0])
    end = next((b for b in lows if curve[b] <= curve[b0] / 10), lows[-1])
    picks = sorted({min(lows, key=lambda b: abs(
        b - b0 * (end / b0) ** (i / max(n - 1, 1)))) for i in range(n)})
    check(len(picks) == n, f"no {n} distinct eviction blocks: {picks}")
    return [(b + 1, (min(curve[:b]) + curve[b]) / 2) for b in picks]


def serve_mix(smi: str):
    """Phase 12's requests: per bucket, tols from its own solo residual
    curve (spread over an order of magnitude) plus one fixed-iteration
    request. Returns (make, expected blocks per request)."""
    from repro_torch.serve import SolveRequest
    plan, expect = [], []
    for name, ny, nx, dtype, n in SERVE_BUCKETS:
        u0 = make_laplace_problem(ny, nx, dtype=dtype, left=1.0)
        curve = residual_curve(u0, SERVE_ITERS // T)
        tols = spread_tols(curve, n - 1)
        print(f"[{name}] residual after blocks 1, 12, {len(curve)} of t={T}: "
              f"{curve[0]:.6e}, {curve[11]:.6e}, {curve[-1]:.6e}; tols "
              + ", ".join(f"{tol:.6e} (block {b})" for b, tol in tols)
              + " and one tol=None")
        for b, tol in tols + [(SERVE_ITERS // T, None)]:
            plan.append((u0, tol))
            expect.append(b)

    def make():
        return [SolveRequest(grid=u0, tol=tol, max_iters=SERVE_ITERS,
                             policy="temporal", t=T) for u0, tol in plan]
    return make, expect


def served(make, superblock: int, tracer=None):
    """One served pass of the mix; returns (server, requests)."""
    from repro_torch.serve import SolveServer
    srv = SolveServer(max_slots=SERVE_SLOTS, superblock=superblock,
                      tracer=tracer)
    reqs = srv.solve(make())
    return srv, reqs


def served_blocks(tracer) -> tuple[int, int]:
    """Blocks a served trace accounts for: the superblocks' block counts
    (one batched K1 and one batched K2 for the residuals each), and the
    lone run_converged's realized blocks (one K1 each)."""
    recs = obs_trace.span_records(tracer)
    return (sum(r["attrs"]["blocks"] for r in recs
                if r["name"] == "serve.block" and not r["attrs"].get("lone")),
            sum(r["attrs"]["iters_done"] // T for r in recs
                if r["name"] == "engine.run_converged"))


def check_solo(reqs, label: str) -> None:
    """Every request bit for bit its solo run at its realized count, on a
    T multiple, converged within tol where it has one."""
    for i, r in enumerate(reqs):
        solo = engine.run(r.grid, policy=r.key.policy, iters=r.iters_done,
                          t=r.key.t)
        check(torch.equal(r.result, solo.cpu()),
              f"{label} request {i} != its solo run at {r.iters_done}")
        check(r.iters_done % T == 0 and 0 < r.iters_done <= SERVE_ITERS,
              f"{label} request {i} ran {r.iters_done} sweeps")
        if r.tol is not None:
            check(r.converged and r.residual <= r.tol,
                  f"{label} request {i} residual {r.residual} > {r.tol}")


def phase_tuner(smi: str):
    """SolveServer.warm on the paper grid in f32 and bf16: one
    measurement a cell, none on the second warm. Returns the winners."""
    from repro_torch.engine import tune
    from repro_torch.serve import SolveServer
    path = build.build_dir() / "engine_tune.json"
    path.unlink(missing_ok=True)
    os.environ[tune.CACHE_ENV] = str(path)
    tune.clear()
    srv = SolveServer()
    shape = (NY + 2, NX + 2)
    won = {}
    for dname, dtype in DTYPES.items():
        before = tune.measure_count
        won[dname] = srv.warm([shape], dtype=dtype, iters=SERVE_ITERS,
                              t=T)[shape]
        check(tune.measure_count == before + 1,
              f"warm {dname} measured {tune.measure_count - before} times")
    for key, rec in json.loads(path.read_text()).items():
        print(f"tune {key.split('|')[1]} {shape}: winner {rec['policy']}; "
              "us a sweep " + ", ".join(f"{p} {us}" for p, us in
                                        rec["us_per_sweep"].items())
              + f"; skipped {rec['skipped']} on {smi}")
    before = tune.measure_count
    for dname, dtype in DTYPES.items():
        again = srv.warm([shape], dtype=dtype, iters=SERVE_ITERS, t=T)
        check(again == {shape: won[dname]}, f"second warm {dname} {again}")
    check(tune.measure_count == before,
          "a second warm must not measure again")
    return won


def phase_solve_serve(smi: str, stats) -> None:
    from repro_torch.serve import SolveRejected, SolveRequest, SolveServer
    print(f"== phase 12: stencil solves as a service, SolveServer("
          f"max_slots={SERVE_SLOTS}, superblock={SERVE_SUPERBLOCK}) at the "
          f"paper's grid, policy=temporal t={T} ==")
    won = phase_tuner(smi)
    probe = make_laplace_problem(NY, NX)
    try:
        SolveServer().submit(SolveRequest(grid=probe, tol=1e-3,
                                          max_iters=1280, policy="temporal",
                                          t=64))
        print("bench_serve's t=64 is admitted on this card")
    except SolveRejected as e:
        print(f"bench_serve's t=64 is rejected at admission:\n{e}")
    make, expect = serve_mix(smi)

    # one at a time: each request's fixed max_iters through engine.run;
    # and the same with each result copied to the host, as served ones are
    def one_at_a_time(host=False):
        outs = [engine.run(r.grid, policy="temporal", iters=r.max_iters,
                           t=T) for r in make()]
        return [u.to("cpu", copy=True) for u in outs] if host else outs

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    solo_wall = timed(one_at_a_time)
    solo_host_wall = timed(lambda: one_at_a_time(host=True))

    tracer = obs_trace.Tracer()
    engine.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    srv, reqs = served(make, SERVE_SUPERBLOCK, tracer)
    lone = srv.submit(SolveRequest(grid=make_laplace_problem(NY, NX),
                                   tol=reqs[2].tol, max_iters=SERVE_ITERS,
                                   policy="temporal", t=T))
    before = srv.stats()["launches"]
    n_conv = sum(r["name"] == "engine.run_converged"
                 for r in obs_trace.span_records(tracer))
    srv.drain()
    torch.cuda.synchronize()
    counts, variants = dict(engine.LAUNCHES), dict(engine.TEMPORAL_VARIANTS)
    k2_variants = dict(engine.ROWCHUNK_VARIANTS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = obs_trace.span_records(tracer)
    convs = [r for r in recs if r["name"] == "engine.run_converged"]
    print(f"served launches {counts}; K1 kernels {variants}; K2 kernels "
          f"{k2_variants}; server "
          f"{srv.stats()['launches']} launches; peak {peak:.2f} GiB on {smi}")
    check(srv.stats()["launches"] == before + 1 and len(convs) == n_conv + 1
          and convs[-1]["attrs"]["iters_done"] == lone.iters_done,
          "the lone request must be one server launch of run_converged")
    batched, lone_blocks = served_blocks(tracer)
    want = batched + lone_blocks
    check(counts == {"shifted": 0, "rowchunk": batched, "dbuf": 0,
                     "temporal": want},
          f"served launches {counts} != the trace's blocks: K1 {want}, "
          f"K2 (residuals) {batched}")
    check(variants == {"jacobi5": want, "laplace9": 0, "radius2": 0,
                       "general": 0},
          f"every served K1 launch must be the jacobi5 kernel: {variants}")
    check(k2_variants == {"jacobi5": batched, "laplace9": 0, "radius2": 0,
                          "general": 0},
          f"every served K2 launch must be the jacobi5 kernel: "
          f"{k2_variants}")
    check(len(srv.buckets) == len(SERVE_BUCKETS),
          f"{len(srv.buckets)} buckets for {len(SERVE_BUCKETS)} grids")
    got = [r.iters_done // T for r in reqs]
    print(f"blocks a request: realized {got}, from the solo curves {expect}")
    check(got == expect, "realized blocks != the solo residual curves'")
    check_solo(reqs + [lone], "served")
    stats["temporal"]["paths"] = {stats["temporal"]["path"]:
                                  stats["temporal"]["launches"],
                                  "solve_serve": want}
    stats["rowchunk"]["paths"] = {stats["rowchunk"]["path"]:
                                  stats["rowchunk"]["launches"],
                                  "solve_serve": batched}

    _, one = served(make, 1)
    for a, b in zip(reqs, one):
        check(a.iters_done == b.iters_done and a.residual == b.residual
              and a.converged == b.converged
              and torch.equal(a.result, b.result),
              "superblock 1 and superblock 4 must serve the same results")
    print("superblock 1 == superblock 4: iters_done, residuals and results")

    tuned = [SolveRequest(grid=make_laplace_problem(NY, NX, dtype=dtype),
                          tol=tol, max_iters=SERVE_ITERS, policy="tuned",
                          t=T)
             for dtype in DTYPES.values() for tol in (reqs[1].tol, None)]
    SolveServer(max_slots=SERVE_SLOTS).solve(tuned)
    for r in tuned:
        check(r.key.policy == won[r.key.dtype],
              f"tuned {r.key.dtype} ran {r.key.policy}, tune won "
              f"{won[r.key.dtype]}")
        solo = engine.run(r.grid, policy=won[r.key.dtype],
                          iters=r.iters_done, t=T)
        check(torch.equal(r.result, solo.cpu()),
              f"tuned {r.key.dtype} != its solo run under {r.key.policy}")
    print(f"policy='tuned' served {[r.iters_done for r in tuned]} sweeps "
          f"under {won}, bit for bit their solo runs")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv, reqs = served(make, SERVE_SUPERBLOCK)
    wall = time.perf_counter() - t0
    kernels = top_kernels(lambda: served(make, SERVE_SUPERBLOCK), n=200)
    dev_ms = sum(ms for _, ms, _ in kernels)
    k1_ms = sum(ms for name, ms, _ in kernels if "temporal" in name)
    k2_ms = sum(ms for name, ms, _ in kernels if "rowchunk" in name)
    d2h_ms = sum(ms for name, ms, _ in kernels if "DtoH" in name)
    points = {r.key.shape: (r.key.shape[0] - 2) * (r.key.shape[1] - 2)
              for r in reqs}
    done = sum(points[r.key.shape] * r.iters_done for r in reqs)
    fixed = sum(points[r.key.shape] * r.max_iters for r in reqs)
    stats_ = srv.stats()
    supers = sum(b["launches"] for b in stats_["per_bucket"].values())
    print(f"served: {len(reqs)} requests in {wall:.6f}s wall, "
          f"{done / wall / 1e9:.3f} GPt/s realized ({done / 1e9:.3f} GPt), "
          f"{stats_['launches']} server launches, evicted_early "
          f"{stats_['evicted_early']}; one at a time: {solo_wall:.6f}s, "
          f"{fixed / solo_wall / 1e9:.3f} GPt/s ({fixed / 1e9:.3f} GPt), "
          f"{solo_host_wall:.6f}s with each result copied to the host; "
          f"served / one at a time {wall / solo_wall:.4f}x wall "
          f"({wall / solo_host_wall:.4f}x with the copies); sweeps "
          f"saved by eviction {sum(r.max_iters - r.iters_done for r in reqs)}"
          f" of {sum(r.max_iters for r in reqs)}; on {smi}")
    print(f"host waits: {supers} superblock or lone launches + {len(reqs)} "
          f"result copies for {len(reqs)} requests "
          f"({(supers + len(reqs)) / len(reqs):.2f} a request; a lone "
          f"run_converged waits once a block besides)")
    print(f"device busy: {dev_ms:.3f} ms of kernels and copies under "
          f"{wall * 1e3:.3f} ms of wall ({dev_ms / (wall * 1e3):.1%}); K1 "
          f"{k1_ms:.3f} ms, K2 (the residuals' sweeps) {k2_ms:.3f} ms, the "
          f"results' copies to the host {d2h_ms:.3f} ms, the rest "
          f"(differences, maxima, freezes, ring and slot copies) "
          f"{dev_ms - k1_ms - k2_ms - d2h_ms:.3f} ms; on {smi}; the kernels "
          f"with the most time:")
    stats["temporal"]["solve_serve"] = {
        "wall_s": wall, "gpts": done / wall / 1e9, "one_at_a_time_s":
        solo_wall, "one_at_a_time_host_s": solo_host_wall,
        "device_ms": dev_ms, "k1_ms": k1_ms, "k2_ms": k2_ms,
        "d2h_ms": d2h_ms}
    for name, ms, n in kernels[:8]:
        print(f"  {ms:10.3f} ms {n:5d}x  {name[:100]}")


DIST_MESHES = {"(4,)": ((4,), ("x",)), "(2, 2)": ((2, 2), ("x", "y"))}
DIAG9 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))
# The specs of tests/test_dist_engine.py: face, row and diagonal taps.
DIST_SPECS = {"jacobi5": jacobi_2d_5pt(),
              "diff3": StencilSpec(offsets=((0, -1), (0, 0), (0, 1)),
                                   weights=(0.25, 0.5, 0.25)),
              "diag9": StencilSpec(offsets=DIAG9, weights=(0.125,) * 8)}


def dist_kernels(spec: StencilSpec, dname: str, mname: str,
                 shape: tuple) -> None:
    """K1 masked and K2 against their plain versions at every shape and
    mask the distributed main path gives them on the mesh ``shape``, the
    masks taken from the executor itself. K1 at depth T: for each shard
    position, its extended block with its pin mask (``_pin_mask``) and
    the four rind strips with that mask's strips (``_rind_strips``,
    contiguous), then the raw shard with the interior's all-zero mask.
    K2 at the remainder round (depth ITERS % T): the extended block, the
    raw shard and the strips that overlap runs it on. Each launch is
    counted and ``torch.equal`` to the plain version."""
    from repro_torch.dist.stencil import _pin_mask, _rind_strips
    dtype = DTYPES[dname]
    px, py = (shape + (1,))[:2]
    hl, wl, r = NY // px, NX // py, spec.radius
    g = torch.Generator(device="cuda").manual_seed(13)

    def same(policy, u, what, **kw):
        got, counts = counted(lambda: getattr(
            engine, f"stencil_{policy}")(u, spec, **kw))
        want = getattr(engine, f"stencil_{policy}_plain")(u, spec, **kw)
        check(counts[policy] == 1 and torch.equal(got, want),
              f"{policy} at {tuple(u.shape)} {dname} mesh {mname} ({what}): "
              f"launches {counts}, max |err| "
              f"{float((got.float() - want.float()).abs().max())}")

    def rand(shp):
        return torch.rand(shp, generator=g, device="cuda").to(dtype)

    d = T * r
    masks = [("raw shard", torch.zeros((hl, wl), dtype=torch.uint8,
                                       device="cuda"))]
    for ix in range(px):
        for iy in range(py):
            m = _pin_mask(hl, wl, d, ix, iy, px, py, "cuda")
            masks.append((f"shard ({ix}, {iy})", m))
            masks += [(f"shard ({ix}, {iy}) strip {i}", m[rs, cs].contiguous())
                      for i, (rs, cs) in enumerate(_rind_strips(hl, wl, d))]
    for what, m in masks:
        same("temporal", rand(m.shape), what, t=T, mask=m)
    k1_shapes = sorted({tuple(m.shape) for _, m in masks})
    dr = (ITERS % T) * r
    ext = torch.empty((hl + 2 * dr, wl + 2 * dr), dtype=torch.uint8)
    k2_shapes = sorted({tuple(ext.shape), (hl, wl)}
                       | {tuple(ext[rs, cs].shape)
                          for rs, cs in _rind_strips(hl, wl, dr)})
    for shp in k2_shapes:
        same("rowchunk", rand(shp), "remainder")
    print(f"[{dname}] mesh {mname}: K1 masked on {len(masks)} (shape, mask) "
          f"cases, the executor's pin masks of all {px * py} shard "
          f"positions, their strips and the interior's, at {k1_shapes}; K2 "
          f"at the remainder's {k2_shapes}: each launched once, bit for "
          f"bit its plain version")


def timed_wall(fn, reps: int = 5):
    """Host seconds of synchronized ``fn()`` calls after a warm one, each
    with the launch counters zeroed just before it (every call must
    launch the same); returns (result, median seconds, (min, max),
    counts, K1 kernels, K2 kernels). The host clock of a host-bound
    path spreads from call to call, hence the median and the range."""
    fn()
    torch.cuda.synchronize()
    walls, seen = [], set()
    for _ in range(reps):
        t0 = time.perf_counter()
        out, counts = counted(fn)
        walls.append(time.perf_counter() - t0)
        k1, k2 = dict(engine.TEMPORAL_VARIANTS), dict(engine.ROWCHUNK_VARIANTS)
        seen.add(json.dumps([counts, k1, k2], sort_keys=True))
    check(len(seen) == 1, f"calls launched differently: {seen}")
    walls.sort()
    return (out, walls[reps // 2], (walls[0], walls[-1]), counts, k1, k2)


def phase_dist(smi: str, stats) -> None:
    from repro_torch.dist import ShardMesh
    from repro_torch.obs.compare import reconcile
    print(f"== phase 13: the distributed stencil on one card, "
          f"run_distributed(policy='auto', iters={ITERS}, t={T}) at "
          f"{NY}x{NX} over four shards on the card ==")
    spec = jacobi_2d_5pt()
    jacobi = {"jacobi5": 0, "laplace9": 0, "radius2": 0, "general": 0}
    runs, solos, paths = {}, {}, {}
    for dname, dtype in DTYPES.items():
        u0 = make_laplace_problem(NY, NX, dtype=dtype)
        solo, solo_wall, spread, _, _, _ = timed_wall(
            lambda: engine.run(u0, policy="temporal", iters=ITERS, t=T))
        solos[dname] = NY * NX * ITERS / solo_wall / 1e9
        print(f"[{dname}] single device engine.run(temporal, t={T}): "
              f"wall={solo_wall:.6f}s (median of 5, {spread[0]:.6f}-"
              f"{spread[1]:.6f}) GPt/s={solos[dname]:.3f}")
        for mname, (shape, axes) in DIST_MESHES.items():
            dist_kernels(spec, dname, mname, shape)
            mesh = ShardMesh(shape, axes)
            # The default overlap=None: four shards on one card, no link
            # to hide, so the serial round.
            sched, shard, _ = engine.plan_distributed(
                u0.shape, dtype, spec, mesh=mesh, policy="auto",
                iters=ITERS, t=T)
            check((sched.policy, sched.t, sched.fused_blocks,
                   sched.remainder, sched.remainder_policy, sched.exchanges,
                   sched.overlap)
                  == ("temporal", T, 125, 3, "rowchunk", 126, False),
                  f"{mname} schedule {sched}")
            bill = engine.price_exchange(sched, shard_shape=shard,
                                         dtype=dtype, spec=spec,
                                         mesh_shape=shape)
            print(f"[{dname}] mesh {mname}: schedule {sched.describe()}; "
                  f"extended shard {shard}; modeled bill "
                  f"({engine.detect().name}): "
                  f"{bill.describe()}")
            for overlap in (False, True):
                out, wall, spread, counts, k1, k2 = timed_wall(
                    lambda: engine.run_distributed(
                        u0, spec, mesh=mesh, policy="auto", iters=ITERS,
                        t=T, overlap=overlap))
                per_round = 5 if overlap else 1
                want = {"shifted": 0, "dbuf": 0,
                        "temporal": 125 * 4 * per_round,
                        "rowchunk": 3 * 4 * (5 if overlap else 1)}
                check(counts == want,
                      f"{mname} overlap={overlap} launches {counts} != {want}")
                check(k1 == dict(jacobi, jacobi5=want["temporal"])
                      and k2 == dict(jacobi, jacobi5=want["rowchunk"]),
                      f"{mname} overlap={overlap}: K1 {k1}, K2 {k2} not "
                      f"all jacobi5")
                check(torch.equal(out, solo),
                      f"{mname} {dname} overlap={overlap}: != single-device "
                      f"engine.run, max |err| "
                      f"{float((out.float() - solo.float()).abs().max())}")
                gpts = NY * NX * ITERS / wall / 1e9
                runs[(dname, mname, overlap)] = {
                    "wall_s": wall, "wall_range_s": spread, "gpts": gpts,
                    "single_gpts": solos[dname],
                    "model_serial_s": bill.serial_s,
                    "model_overlapped_s": bill.overlapped_s,
                    "k1": counts["temporal"], "k2": counts["rowchunk"]}
                print(f"[{dname}] mesh {mname} overlap={overlap}: == "
                      f"single device bit for bit; launches K1 "
                      f"{counts['temporal']} K2 {counts['rowchunk']}; "
                      f"wall={wall:.6f}s (median of 5, {spread[0]:.6f}-"
                      f"{spread[1]:.6f}) GPt/s={gpts:.3f} (single device "
                      f"{solos[dname]:.3f}); modeled serial "
                      f"{bill.serial_s * 1e3:.6f} ms, overlapped "
                      f"{bill.overlapped_s * 1e3:.6f} ms; on {smi}")
            # The main path as a user calls it (overlap left to its
            # default), counters zeroed just before and read just after.
            out, counts = counted(lambda: engine.run_distributed(
                u0, spec, mesh=mesh, policy="auto", iters=ITERS, t=T))
            want = {"shifted": 0, "dbuf": 0, "temporal": 500, "rowchunk": 12}
            check(counts == want and torch.equal(out, solo),
                  f"{mname} {dname} default overlap: launches {counts} != "
                  f"{want} or != single device")
            paths[(dname, mname)] = counts
            print(f"[{dname}] mesh {mname} run_distributed(u0, policy='auto',"
                  f" iters={ITERS}, t={T}) (overlap=None resolves to "
                  f"{sched.overlap}): == single device bit for bit; launches "
                  f"K1 {counts['temporal']} K2 {counts['rowchunk']}")
    for policy in ("temporal", "rowchunk"):
        stats[policy]["paths"]["run_distributed(auto, iters=1003, t=8, "
                               "(4,))"] = paths[("bfloat16", "(4,)")][policy]
    stats["temporal"]["run_distributed"] = {
        f"{d} {m} overlap={'on' if o else 'off'}": v
        for (d, m, o), v in runs.items()}

    g = torch.Generator(device="cuda").manual_seed(0)
    u = make_laplace_problem(32, 64)
    u[...] = torch.rand(u.shape, generator=g, device="cuda")
    n = 0
    for sname, dspec in DIST_SPECS.items():
        want = engine.run(u, dspec, policy="rowchunk", iters=6)
        for mname, (shape, axes) in DIST_MESHES.items():
            mesh = ShardMesh(shape, axes)
            for policy in ("reference", "shifted", "rowchunk", "temporal"):
                for t in (1, 3):
                    for overlap in (True, False):
                        got = engine.run_distributed(
                            u, dspec, mesh=mesh, policy=policy, iters=6,
                            t=t, overlap=overlap)
                        check(torch.equal(got, want),
                              f"matrix {sname} {mname} {policy} t={t} "
                              f"overlap={overlap} != single device")
                        n += 1
    print(f"the reference test's matrix on the card: {n} runs at 32x64 "
          f"(random ring), each bit for bit the single-device rowchunk "
          f"solve")

    u0 = make_laplace_problem(NY, NX, dtype=torch.bfloat16)
    plain = engine.run_distributed(u0, spec, mesh=ShardMesh((4,), ("x",)),
                                   policy="auto", iters=ITERS, t=T)
    for overlap in (False, True):
        tracer = obs_trace.Tracer()
        with obs_trace.use_tracer(tracer):
            traced = engine.run_distributed(
                u0, spec, mesh=ShardMesh((4,), ("x",)), policy="auto",
                iters=ITERS, t=T, overlap=overlap)
        check(torch.equal(traced, plain),
              f"traced run (overlap={overlap}) != untraced")
        rounds = sum(e.name == "dist.round" for e in tracer.events)
        check(rounds == 126, f"{rounds} dist.round spans, want 126")
        rep = reconcile(tracer)
        print(f"traced main path, bf16, (4,), overlap={overlap}: 126 "
              f"rounds, bit for bit the untraced run; on {smi}")
        print(rep.describe())


def main() -> None:
    smi, peaks = card()
    print(f"== phase 1: card: {smi} ==")
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    print(f"== phase 2: built {sorted(libs)} in "
          f"{time.perf_counter() - t0:.1f}s ==")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stats: dict = {}
    phase_kernels(peaks, stats)
    phase_subnormals()
    phase_main(smi, stats)
    phase_paths(stats)
    phase_flash(peaks, stats)
    phase_serve(smi, stats)
    gc.collect()  # phase 7's model, so phase 9's peak memory is its own
    torch.cuda.empty_cache()
    phase_conv(peaks, stats)
    phase_ssm(smi, stats)
    gc.collect()
    torch.cuda.empty_cache()
    phase_stream(peaks, stats, smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_hybrid(smi, stats)
    gc.collect()
    torch.cuda.empty_cache()
    phase_solve_serve(smi, stats)
    phase_dist(smi, stats)
    phase_grayskull(smi, stats)
    kernels = []
    for policy, (kid, replaces) in KERNELS.items():
        s = stats[policy]
        kernels.append({
            "name": f"{kid} {policy}", "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": s["launches"],
            "path": s["path"], **({"paths": s["paths"]} if "paths" in s
                                  else {}),
            "max_abs_err": s["max_abs_err"],
            "dtype": "bfloat16", **s["bfloat16"],
            "float32": s["float32"],
            **{k: s[k] for k in ("cases", "solve_serve", "run_distributed",
                                 "grayskull_sim") if k in s}})
    kid, replaces = FLASH
    s = stats["flash"]
    for dname, kernel in (("bfloat16", "wgmma (tensor cores)"),
                          ("float32", "split TF32 (wgmma, 3 products)")):
        kernels.append({
            "name": f"{kid} flash_attention"
                    + (" f32" if dname == "float32" else ""),
            "route": "cuda", "source": FLASH_ROUTES[dname][1],
            "replaces": replaces, "dtype": dname, "kernel": kernel,
            "shape": "B=4 S=2048 H=16 K=2 hd=128 causal",
            **({"launches": s["launches"], "path": s["path"]}
               if dname == "bfloat16" else {}), **s[dname],
            # zamba2-7b's serving shape (its launches from phase 11), and
            # hubert-xlarge's heads (no path of the port runs them yet)
            **{key: {"launches": 0, **s[key][dname]}
               for key in ("hd112", "hd80")}})
    kid, source, replaces = CONV
    s = stats["conv1d"]
    kernels.append({
        "name": f"{kid} conv1d_depthwise_causal", "route": "cuda",
        "source": source, "replaces": replaces, "launches": s["launches"],
        "path": s["path"], "paths": {s["path"]: s["launches"], **s["paths"]},
        "max_abs_err": s["max_abs_err"],
        "dtype": "bfloat16", "shape": "B=4 L=2048 D=5376 K=4 bias",
        **s["bfloat16"], "float32": s["float32"]})
    for name, (kid, replaces, shape) in STREAM.items():
        s = stats[name]
        kernels.append({
            "name": f"{kid} {name}", "route": "cuda",
            "source": STREAM_SOURCE, "replaces": replaces,
            "launches": s["launches"], "path": s["path"],
            "max_abs_err": s["max_abs_err"], "shape": shape,
            **{k: s[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            **{k: s[k] for k in ("bytes_once_ms", "traffic_ms", "l2_tbs",
                                 "l2_probe_tbs", "k5c_l2_tbs", "factors",
                                 "split", "sync_ms")
               if k in s}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
