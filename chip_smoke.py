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
   policy call (the views' copies too), each beside its own traffic bound;
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
    ``sync=False``, are printed.
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
12. one JSON line listing the kernels, then the card's name and power
    limit, then the result line.

It imports nothing of JAX and nothing of the ``repro`` package, and exits
non-zero without a card or outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import gc
import json
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

from repro_torch import configs, engine  # noqa: E402
from repro_torch.core.stencil import (StencilSpec, apply_stencil,  # noqa: E402
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


def phase_stream(peaks, stats) -> None:
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
        k_ms = device_ms(lambda: fn(x, **kw))
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
            # what the factor reads and the one write move, as the TPU does
            s["traffic_ms"] = ((kw["factor"] + 1) * x.numel()
                               * x.element_size() / bw * 1e3)
            extra = f" factor_traffic_ms={s['traffic_ms']:.6f}"
        print(f"{STREAM[name][0]} {name:18s} {STREAM[name][2]}: "
              f"kernel_ms={k_ms:.6f} plain_ms={p_ms:.6f} "
              f"bound_ms={s['bound_ms']:.6f} ({s['bound_by']}){extra} "
              f"copy_ms={'null' if lib_ms is None else f'{lib_ms:.6f}'}")
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
            check(name.startswith("paper_") or float(us) > 0,
                  f"table {t} row {name} measured no time")
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched by launch.access")
        stats[name].update(launches=n, path="launch.access tables II-VI")


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
    phase_stream(peaks, stats)
    gc.collect()
    torch.cuda.empty_cache()
    phase_hybrid(smi, stats)
    kernels = []
    for policy, (kid, replaces) in KERNELS.items():
        s = stats[policy]
        kernels.append({
            "name": f"{kid} {policy}", "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": s["launches"],
            "path": s["path"], "max_abs_err": s["max_abs_err"],
            "dtype": "bfloat16", **s["bfloat16"],
            "float32": s["float32"],
            **({"cases": s["cases"]} if "cases" in s else {})})
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
            **{k: s[k] for k in ("traffic_ms", "split", "sync_ms")
               if k in s}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
