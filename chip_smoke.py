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
   lengths that are not a multiple of the key tile, at chatglm3-6b's
   serving shape (B=4, S=2048, H=32, K=2, hd=128 causal: a GQA group of
   16), at hd 112 (zamba2-7b:
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
    against the bill.
    13b: one process a shard. Four ranks share the card over gloo
    (``repro_torch.dist.process.spawn``: ``torch.multiprocessing`` and a
    ``FileStore`` in a temporary directory; the halos staged through
    pinned host buffers), each running the same call over a
    ``ProcessMesh``, ``(4,)`` and ``(2, 2)``, bf16 and f32: every rank's
    grid ``torch.equal`` to its single-device ``engine.run`` and (rank 0)
    the in-process mesh, 125 K1 and 3 K2 a rank (500 and 12 in all,
    counters zeroed just before the call on each rank), the wall the
    median of three (a check of the transport, not scaling: the halos
    cross the host). Then ``launch.solve --devices 4 --dist-backend gloo
    --check`` under ``torch.distributed.run`` (four ranks on the card).
    13c, only with two cards or more: the in-process mesh over distinct
    cards (its default layout) and NCCL ranks one a card, held to the
    same checks; with one card a line says it was not run;
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
15. the paper's Jacobi entry points at the paper's grid, bf16 and f32:
    ``core.jacobi.jacobi_run_temporal(u, 1003, t=8)`` must equal
    ``engine.run(policy="temporal")`` bit for bit with 125 K1 (jacobi5)
    and 3 K2 launches; ``jacobi_solve(check_every=200,
    policy="rowchunk")`` at a tolerance between the second and third
    chunk residuals of the same loop over K2's plain version must realize
    that loop's iterations, residual and grid bit for bit, one K2 launch
    a sweep; ``kernels.ops.jacobi_step`` at v0, v1, v1db and v2 and the
    deprecated ``kernels.jacobi`` wrappers (which alone warn) must each
    launch K4, K2, K3 or K1 once and equal ``engine.stencil_*`` bit for
    bit, and ``ref`` launch nothing; ``python -m repro_torch.launch.solve
    --kernel v2 --temporal 8 ... --iters 1003 --dtype bfloat16 --check``
    runs in a subprocess and must print ``CHECK OK``; the three example
    twins (``repro_torch.examples.{quickstart,distributed_jacobi,
    serve_lm}``) run on the card, the stencil ones launching kernels;
16. three more decoders at full width and depth, served as in phase 7
    (random weights from a seed, ``attn_impl="flash"``, 4 requests of
    2048-token prompts and 32 greedy tokens): ``chatglm3-6b`` (28 layers,
    32 heads of 128 over 2 KV heads: a GQA group of 16, half-dim rotary)
    and ``internvl2-2b``'s text backbone (24 layers, 16 heads over 8 KV
    heads) must launch K8 once a layer in the prefill wave, all on the
    tensor-core kernel, and nothing else; against ``attn_impl="jnp"``, at
    the JAX package's bound (rtol=5e-2, atol=8e-2), each layer's attention
    through K8 fed either route's stream, and the whole prefill's logits
    in f32 compute (K8's split-TF32 route, once a layer), and for
    internvl2-2b the whole bf16 prefill's logits; chatglm3-6b's whole
    bf16 excess is printed beside both routes' distance to f32 and not
    gated (its jnp route alone is over the bound from f32, as zamba2-7b's
    is in phase 11: ``WHOLE_BF16_UNGATED``);
    internvl2-2b also runs one forward with 256 image embeddings ahead of
    1792 tokens (24 K8 launches, finite logits); ``minicpm3-4b`` (62
    layers of MLA) must launch no K8 at all (its q/k head dim, 96, is not
    v's, 64, so its prefill attends by the plain chunked path, as the
    reference's), and in f32 its absorbed decode over the latent cache
    must agree with the expanded path at every position (rtol = atol =
    1e-3: the two differ by re-association only). Each prints its
    parameter count, peak memory, prefill and decode times (wall, and
    kernel time from ``torch.profiler``) and must give the same tokens on
    a second greedy run; the memory is freed between models;
17. MoE serving at full width: ``qwen3-moe-30b-a3b`` (48 layers, 128
    experts of ff 768, top 8, 32 heads of 128 over 4 KV heads: a GQA
    group of 8) with its parameters stored in bf16 (``param_dtype``),
    served as in phase 7: K8 must launch once a layer in the prefill
    wave, all on the tensor-core kernel, and nothing else; each layer's
    attention through K8 within the JAX package's bound (rtol 5e-2, atol
    8e-2) of the jnp route's, fed either route's stream; layer 0's MoE at
    full width on one group of 256 tokens in bf16 on the card within
    2e-2 of max |out| of the same parameters and inputs on the CPU in
    f32; ``moe_drop_frac`` at prefill (groups of 256) and at a decode
    step (a group of 4 tokens at capacity 1) printed; times, peak memory
    and the second greedy run as in phase 7;
18. the encoder at full width: ``hubert-xlarge`` (48 layers, d 1280, 16
    heads of 80, non-causal) on frames made from a seed (B 8, S 1024,
    512 features; ``attn_chunk`` 512, so both routes take the long
    path): the ``attn_impl="flash"`` forward must launch K8 once a layer
    (hd 80, non-causal) and nothing else, each layer's attention within
    the JAX package's bound of the jnp route's on both streams; then four
    AdamW steps with remat ``"full"`` through ``make_train_step``, each
    loss finite and no kernel launched (ms a step, peak memory, ce), and
    one more under ``torch.profiler`` (its busy share and top kernels);
19. training: ``python -m repro_torch.launch.train --arch qwen2.5-3b
    --steps 5 --batch 8 --seq 128 --ckpt-every 20`` at full width and
    depth (5 finite losses; ms a step, peak memory, ce each step), then
    the same step in this process, three timed and one profiled (a
    checkpoint of that state would not fit the time: the 2-layer state's
    save and restore are timed below, with the disk's free space); at
    full width and 2 layers, with deterministic algorithms: a run killed
    once its step-5 checkpoint is on disk and resumed with ``--resume
    auto`` must end in the uninterrupted run's state bit for bit after
    10 steps (the
    digest of every parameter and moment), the gradients at ``accum=2``
    within 5e-2 of each tensor's largest at ``accum=1``, and a run whose
    step raises once must restore, retry and end in the clean run's
    state; K8 and K7 must refuse a gradient on the card; one AdamW step
    of each family at full width and 2 layers (zamba2: 7, one group and
    a tail layer) with finite loss and gradients; both training example
    twins; no kernel launched by any of it;
20. the dry run and the roofline, and the sharded LM pieces: (a) the
    partitioned dry run (``repro_torch.launch.dryrun``): each cell's
    program on DTensors over the production mesh (a fake process group
    of 256 or 512 ranks, device type ``cuda``), counted on ``meta`` under
    ``gpu_sm90``, in four worker processes started after phase 2 (at a
    lower priority, no card visible to them) beside phases 3-19, on the
    subset ``DRYRUN_CELLS`` (the 80 cells take longer than the phase
    waits; the CLI counts all of them): qwen2.5-3b's prefill_32k,
    decode_32k and train_4k on pod, qwen3-moe-30b-a3b's train_4k on
    multipod (the cross-pod term), and cells of every other family.
    Every worker must exit 0 and no record may be an error (errors are
    counted by family and printed with DTensor's message first). Each
    counted cell prints its collective bytes by
    op and ``collective_s`` beside ``compute_s`` and ``memory_s``, then
    the roofline and dry-run tables and the seconds. (b) Four
    cells on the card, each also counted (unpartitioned, one card) on
    ``meta`` at the same shapes:
    qwen2.5-3b ``prefill_32k`` at 2 x 32768 on ``attn_impl="flash"`` (K8
    once a layer, 36, as the counter counts; the jnp route's count beside
    it), ``decode_32k`` with 8 sequences, one token against a filled
    32768-token cache, ``train_4k`` at 1 x 4096 with remat ``"full"``
    (AdamW, one microbatch), and mamba2-2.7b ``long_500k`` (batch 1):
    median ms, ``max_memory_allocated`` beside the counter's memory per
    device, the counted FLOPs and bytes, ``compute_s``, ``memory_s`` and
    ``bound_s`` under ``gpu_sm90``'s published peaks, and bound_s over the
    measured time; every cut of the cell is listed as ``reduced``. K8 at
    the prefill's attention shape (B=2, S=32768, H=16, K=2, hd=128) is
    held against its plain version (3e-2) and timed beside its bound and
    SDPA. (c) On in-process meshes of the card: K8 under a (2, 2) data x
    model mesh bit for bit the unsharded call (4 launches); K7 after
    ``conv_halo_exchange`` on 4 sequence shards of mamba2-2.7b's conv at
    full width bit for bit the unsharded K7 (4 launches);
    ``ssd_sequence_parallel`` on 4 shards within 2e-4 of the single-device
    SSD (the reference test's shapes; at mamba2-2.7b's heads 2e-4 of
    max|y|); qwen2.5-3b's 36 layers in 4 pipeline stages in f32, the
    forward bit for bit the sequential one at equal microbatch size and
    within 2e-5 of max |y| of the whole batch at once (its GEMMs sum 4x
    the rows in another order), the gradients within 5e-4 / 5e-5; ``compressed_psum`` over 4 replicas, int8 and bf16, on the card
    bit for bit the CPU's; ``remesh_state`` of a state from (2, 2) onto
    (2,), gathered bit for bit. Each piece's inputs come from its own
    seed. (d) The same pieces one rank a shard: four gloo ranks sharing
    the card (``dist.process.spawn``), each drawing phase (c)'s inputs
    (its pipeline stage of 9 layers from the generator state (c) kept),
    on ``ProcessMesh``es (2, 2) and (4,): K8 under ``use_mesh`` (1 launch
    a rank), K7 after the ``ppermute`` halo (1 a rank), the SSD, the
    pipeline's forward and gradients, ``compressed_psum`` and the remesh
    onto (2,) over ranks 0-1, each rank's result bit for bit (c)'s for
    its shard (``state_digest``); the pipeline's host us a step a rank.
    With 4 cards or more the same runs over NCCL, one rank a card;
    otherwise it prints that it did not run. (e) The partitioned LM
    program (``repro_torch.launch.partition``) on four gloo ranks
    sharing the card: qwen2.5-3b at full width, 4 layers, f32, prefill
    of 2 x 2048 tokens with ``attn_impl="flash"`` on a (2, 2) data x
    model ``DeviceMesh`` over the ranks (device type ``cuda``), K8
    through ``local_map`` (4 launches a rank); rank 0's logits within
    2e-5 of max |y| of the single-card forward of the same layers and
    inputs, and each rank's ``CommDebugMode`` counts and the counter's
    bytes by op equal to the fake-group count of the same program on
    ``meta``. Four gloo ranks first try each collective that count holds
    on CUDA tensors, in the functional form DTensor issues, one spawn an
    op; if gloo refuses one (an error, or a rank ended by a signal:
    PyTorch 2.11's gloo ends a rank with SIGSEGV in the functional
    all-gather's wait on CUDA tensors), the phase prints the refusal and
    the op and runs the program over a fake group on CUDA tensors in
    this process instead (K8's launches and the counts checked, the
    output not: the real check waits for NCCL on 4 cards);
21. one JSON line listing the kernels, then the card's name and power
    limit, then the result line. Each phase's seconds are printed as it
    ends, and all of them before the JSON line.

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
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "drives the CUDA kernels and needs a card")

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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
from repro_torch import roofline  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeCell  # noqa: E402
from repro_torch.engine.device import get_device  # noqa: E402
from repro_torch.launch import access, dryrun, tuning  # noqa: E402
from repro_torch.launch import report as dry_report  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.train.checkpoint import state_digest  # noqa: E402
from repro_torch.layers.moe import MoE, capacity, moe_ffn  # noqa: E402
from repro_torch.models.base import ParamInit  # noqa: E402
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
                (4, 2048, 16, 16, 80, False, 512),
                (4, 2048, 32, 2, 128, True, 512),
                (4, 2048, 32, 4, 128, True, 512),
                (8, 1024, 16, 16, 80, False, 512)]
# (B, S, H, K, hd) of a timed shape -> the key of its stats: qwen2.5-3b's,
# zamba2-7b's, hubert-xlarge's heads at the serving wave's B and S,
# chatglm3-6b's (a GQA group of 16), qwen3-moe-30b-a3b's (a group of 8)
# and hubert-xlarge's at phase 18's B 8 and S 1024 (non-causal)
FLASH_TIMED = {(4, 2048, 16, 2, 128): "hd128", (4, 2048, 32, 32, 112): "hd112",
               (4, 2048, 16, 16, 80): "hd80", (4, 2048, 32, 2, 128): "group16",
               (4, 2048, 32, 4, 128): "group8",
               (8, 1024, 16, 16, 80): "hubert"}
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
             peaks, unfused: bool = False,
             mask: torch.Tensor | None = None) -> tuple[float, str]:
    """Least time for the function: each input byte (the grid, and the
    pin ``mask`` when one is given) read once and each output byte
    written once, against the f32 operations it must do at the published
    peak, which counts a fused multiply-add as two; with ``unfused`` at
    half that rate, since the kernels must issue each multiply and add
    alone to stay bit for bit (no contraction)."""
    bw, flops = peaks.bw, peaks.f32 / (2 if unfused else 1)
    r = spec.radius
    hi, wi = u.shape[-2] - 2 * r, u.shape[-1] - 2 * r
    nbytes = u.numel() * u.element_size() + hi * wi * u.element_size()
    if mask is not None:
        nbytes += mask.numel() * mask.element_size()
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
            # uint8 of the grid's shape: the form the distributed
            # executor hands K1, so no conversion is timed with it
            mask = (torch.rand(u.shape, device="cuda") < 0.01).to(
                torch.uint8)
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
    b_ms, b_by = bound_ms("temporal", spec, u, T, peaks, mask=mask)
    nc_ms, nc_by = bound_ms("temporal", spec, u, T, peaks, unfused=True,
                            mask=mask)
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
            key = FLASH_TIMED.get((b, sq, h, kh, hd))
            if key is None:
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
            s[key][dname].update(shape=label, max_abs_err=err, **timed)
            if key == "hd128":
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
    model.requires_grad_(False)
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
    model.requires_grad_(False)
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
    model.requires_grad_(False)
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


def rank_meshes(world: int) -> dict:
    """The process meshes phase 13b/c runs on ``world`` ranks: the row
    mesh, and a 2-D one where ``world`` splits so."""
    meshes = {f"({world},)": ((world,), ("x",))}
    if world >= 4 and world % 2 == 0:
        meshes[f"(2, {world // 2})"] = ((2, world // 2), ("x", "y"))
    return meshes


def rank_dist(rank: int, out_dir: str, reps: int) -> None:
    """One rank of phase 13b/c (started by ``dist.process.spawn``): on each
    of :func:`rank_meshes`, in bf16 and f32, the main path over a
    ``ProcessMesh`` held to this rank's single-device ``engine.run`` (and,
    on rank 0, the in-process mesh on its card), its launches counted, its
    wall timed ``reps`` times behind a barrier; one JSON file a rank."""
    import torch.distributed as tdist
    from repro_torch.dist import ProcessMesh, ShardMesh
    spec = jacobi_2d_5pt()
    res = {}
    for mname, (shape, axes) in rank_meshes(tdist.get_world_size()).items():
        mesh = ProcessMesh(shape, axes)
        dev = mesh.device_here
        for dname, dtype in DTYPES.items():
            u0 = make_laplace_problem(NY, NX, dtype=dtype, device=dev)
            sched, _, _ = engine.plan_distributed(
                u0.shape, dtype, spec, mesh=mesh, policy="auto", iters=ITERS,
                t=T)

            def call(overlap=None):
                return engine.run_distributed(u0, spec, mesh=mesh,
                                              policy="auto", iters=ITERS, t=T,
                                              overlap=overlap)
            solo = engine.run(u0, spec, policy="temporal", iters=ITERS, t=T)
            call()  # warm
            out, counts = counted(call)
            k1 = dict(engine.TEMPORAL_VARIANTS)
            inproc = None
            if mesh.rank == 0:
                inproc = torch.equal(out, engine.run_distributed(
                    u0, spec, mesh=ShardMesh(shape, axes, [dev] * len(
                        mesh.devices)), policy="auto", iters=ITERS, t=T))
            walls = []
            for _ in range(reps):
                tdist.barrier()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize(dev)
                walls.append(time.perf_counter() - t0)
            # The split forced on: each rank's interior on a side stream
            # before the exchange (the default above is serial when the
            # ranks share a card).
            other, other_counts = counted(lambda: call(not sched.overlap))
            res[f"{dname} {mname}"] = {
                "other_overlap": [not sched.overlap, torch.equal(other, solo),
                                  other_counts],
                "equal_solo": torch.equal(out, solo), "equal_inproc": inproc,
                "max_err": float((out.float() - solo.float()).abs().max()),
                "counts": counts, "k1": k1,
                "walls": walls, "overlap": sched.overlap,
                "devices": [str(d) for d in mesh.devices],
                "rounds": sched.exchanges}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def check_ranks(label: str, backend: str, world: int, smi: str,
                reps: int = 3) -> dict:
    """Spawn ``world`` ranks over ``backend`` running :func:`rank_dist`,
    check what each saved and print it; return the per-cell rows."""
    import tempfile
    from repro_torch.dist import process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        process.spawn(rank_dist, world, tmp, reps, backend=backend,
                      timeout_s=300)
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{k}.json").read_text())
                 for k in range(world)]
    spawn_s = time.perf_counter() - t0
    rows = {}
    for cell in ranks[0]:
        per = [r[cell] for r in ranks]
        mult = 5 if per[0]["overlap"] else 1
        want = {"shifted": 0, "dbuf": 0, "temporal": 125 * mult,
                "rowchunk": 3 * mult}
        for k, r in enumerate(per):
            check(r["equal_solo"] and r["counts"] == want
                  and r["k1"]["jacobi5"] == want["temporal"],
                  f"{label} {cell} rank {k}: == single device "
                  f"{r['equal_solo']} (max |err| {r['max_err']}), launches "
                  f"{r['counts']} != {want}, K1 variants {r['k1']}")
            ov, same, counts = r["other_overlap"]
            m = 5 if ov else 1
            check(same and counts == {"shifted": 0, "dbuf": 0,
                                      "temporal": 125 * m,
                                      "rowchunk": 3 * m},
                  f"{label} {cell} rank {k} overlap={ov}: == single device "
                  f"{same}, launches {counts}")
        check(per[0]["equal_inproc"],
              f"{label} {cell}: rank 0's grid != the in-process mesh")
        k1 = sum(r["counts"]["temporal"] for r in per)
        k2 = sum(r["counts"]["rowchunk"] for r in per)
        walls = sorted(max(r["walls"][i] for r in per) for i in range(reps))
        wall = walls[reps // 2]
        rows[cell] = {"wall_s": wall, "wall_range_s": (walls[0], walls[-1]),
                      "host_us_a_round": wall / per[0]["rounds"] * 1e6,
                      "gpts": NY * NX * ITERS / wall / 1e9, "k1": k1,
                      "k2": k2, "overlap": per[0]["overlap"],
                      "devices": per[0]["devices"]}
        print(f"[{label}] {cell}: {world} ranks over {backend} on "
              f"{per[0]['devices']}: every rank == its single-device "
              f"engine.run bit for bit, rank 0 == the in-process mesh; "
              f"launches K1 {k1} K2 {k2} in all ({per[0]['counts']} a "
              f"rank); wall={wall:.6f}s (median of {reps} of the slowest "
              f"rank, {walls[0]:.6f}-{walls[-1]:.6f}), "
              f"{rows[cell]['host_us_a_round']:.1f} us a round over "
              f"{per[0]['rounds']} rounds, GPt/s={rows[cell]['gpts']:.3f}; "
              f"overlap={per[0]['other_overlap'][0]} also bit for bit "
              f"({per[0]['other_overlap'][2]['temporal']} K1 a rank); "
              f"on {smi}")
    print(f"[{label}] spawn and all cells: {spawn_s:.1f}s")
    return rows


def torchrun_cli(world: int, backend: str, smi: str) -> None:
    """``launch.solve --devices N`` one shard a rank under
    ``torch.distributed.run`` (a local rendezvous), bf16, ``--check``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", "-m", "repro_torch.launch.solve",
           "--ny", str(NY), "--nx", str(NX), "--iters", str(ITERS),
           "--depth", str(T), "--devices", str(world), "--dtype",
           "bfloat16", "--dist-backend", backend, "--check"]
    t0 = time.perf_counter()
    got = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    out = got.stdout
    check(got.returncode == 0 and "CHECK OK" in out and "bit for bit" in out
          and f"{world} ranks over {backend}" in out,
          f"torch.distributed.run launch.solve ({backend}) exit "
          f"{got.returncode}:\n{out[-3000:]}\n{got.stderr[-3000:]}")
    print(f"torch.distributed.run --nproc-per-node={world} -m "
          f"repro_torch.launch.solve --devices {world} --dist-backend "
          f"{backend} --check ({time.perf_counter() - t0:.1f}s, rank 0's "
          f"lines):")
    for line in out.splitlines():
        if line.startswith(("schedule:", "kernel=", "wall=", "distributed",
                            "CHECK")):
            print(f"  {line}")
    print(f"  on {smi}")


def phase_dist_cards(smi: str, stats) -> None:
    """Phase 13b and 13c: one process a shard, and the cards present."""
    print(f"== phase 13b: run_distributed(policy='auto', iters={ITERS}, "
          f"t={T}) at {NY}x{NX}, four ranks sharing the card over gloo ==")
    rows = check_ranks("13b gloo", "gloo", 4, smi)
    torchrun_cli(4, "gloo", smi)
    for policy in ("temporal", "rowchunk"):
        stats[policy]["paths"]["run_distributed(auto, iters=1003, t=8, "
                               "ProcessMesh((4,)), 4 gloo ranks)"] = \
            rows["bfloat16 (4,)"]["k1" if policy == "temporal" else "k2"]
    stats["temporal"]["run_distributed_ranks"] = {
        f"gloo {cell}": row for cell, row in rows.items()}
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"== phase 13c: needs 2 cards or more (the in-process mesh "
              f"over distinct cards, NCCL ranks one a card); {cards} "
              f"present: not run ==")
        return
    print(f"== phase 13c: {cards} cards: the in-process mesh over them, "
          f"then NCCL ranks one a card ==")
    from repro_torch.dist import ShardMesh
    spec = jacobi_2d_5pt()
    for dname, dtype in DTYPES.items():
        u0 = make_laplace_problem(NY, NX, dtype=dtype)
        solo = engine.run(u0, spec, policy="temporal", iters=ITERS, t=T)
        for mname, (shape, axes) in DIST_MESHES.items():
            mesh = ShardMesh(shape, axes)
            check(len(set(mesh.devices)) == min(cards, 4),
                  f"default mesh {mname} on {mesh.devices}")
            for overlap in (False, True, None):
                sched, _, _ = engine.plan_distributed(
                    u0.shape, dtype, spec, mesh=mesh, policy="auto",
                    iters=ITERS, t=T, overlap=overlap)
                mult = 5 if sched.overlap else 1
                want = {"shifted": 0, "dbuf": 0, "temporal": 500 * mult,
                        "rowchunk": 12 * mult}
                out, wall, spread, counts, _, _ = timed_wall(
                    lambda: engine.run_distributed(
                        u0, spec, mesh=mesh, policy="auto", iters=ITERS,
                        t=T, overlap=overlap), reps=3)
                check(counts == want and torch.equal(out, solo),
                      f"13c {dname} {mname} overlap={overlap}: launches "
                      f"{counts} != {want} or != single device")
                print(f"[13c {dname}] in-process mesh {mname} on "
                      f"{[str(d) for d in mesh.devices]} overlap={overlap} "
                      f"(resolved {sched.overlap}): == single device bit for "
                      f"bit; launches K1 {counts['temporal']} K2 "
                      f"{counts['rowchunk']}; wall={wall:.6f}s (median of 3,"
                      f" {spread[0]:.6f}-{spread[1]:.6f}); on {smi}")
    world = 4 if cards >= 4 else 2
    rows = check_ranks("13c nccl", "nccl", world, smi)
    stats["temporal"]["run_distributed_ranks"].update(
        {f"nccl {cell}": row for cell, row in rows.items()})
    torchrun_cli(world, "nccl", smi)


# version -> (its policy, its deprecated wrapper in kernels/jacobi.py)
JACOBI_VERSIONS = {"v0": ("shifted", "jacobi_v0_shifted"),
                   "v1": ("rowchunk", "jacobi_v1_rowchunk"),
                   "v1db": ("dbuf", "jacobi_v1_dbuf"),
                   "v2": ("temporal", "jacobi_v2_temporal")}
SOLVE_EVERY = 200


def add_path(stats, policy: str, path: str, n: int) -> None:
    stats[policy].setdefault("paths", {})[path] = n


def plain_solve(u: torch.Tensor, spec: StencilSpec, tol: float,
                max_iters: int) -> tuple[torch.Tensor, int, float, list]:
    """``jacobi_solve``'s loop over K2's plain version: chunks of
    SOLVE_EVERY sweeps until the chunk's flushed max update is <= tol."""
    from repro_torch.core.stencil import max_update
    res, it, curve = float("inf"), 0, []
    while res > np.float32(tol) and it < max_iters:
        v = u
        for _ in range(SOLVE_EVERY):
            v = engine.stencil_rowchunk_plain(v, spec)
        res = float(max_update(v, u, spec.radius))
        u, it = v, it + SOLVE_EVERY
        curve.append(res)
    return u, it, res, curve


def phase_jacobi(smi: str, stats) -> None:
    from repro_torch.core import jacobi as J
    from repro_torch.examples import distributed_jacobi, quickstart, serve_lm
    from repro_torch.kernels import jacobi as legacy
    from repro_torch.kernels import ops
    print(f"== phase 15: the paper's Jacobi entry points at {NY}x{NX} ==")
    spec = jacobi_2d_5pt()
    for dname in ("bfloat16", "float32"):
        dtype = DTYPES[dname]
        u0 = make_laplace_problem(NY, NX, dtype=dtype)
        got, counts = counted(lambda: J.jacobi_run_temporal(u0, ITERS, t=T))
        variants = dict(engine.TEMPORAL_VARIANTS)
        want = engine.run(u0, spec, policy="temporal", iters=ITERS, t=T)
        print(f"[{dname}] jacobi_run_temporal(u, {ITERS}, t={T}): launches "
              f"{counts}")
        check(counts == {"shifted": 0, "rowchunk": 3, "dbuf": 0,
                         "temporal": 125} and variants["jacobi5"] == 125,
              f"jacobi_run_temporal must launch 125 jacobi5 K1 and 3 K2: "
              f"{counts}, {variants}")
        check(torch.equal(got, want),
              "jacobi_run_temporal != engine.run(policy='temporal')")
        if dname == "bfloat16":
            for policy in ("temporal", "rowchunk"):
                add_path(stats, policy, "jacobi_run_temporal(u, 1003, t=8)",
                         counts[policy])

        # A tolerance between the plain chain's second and third chunk
        # residuals: the solve stops after three chunks.
        _, _, _, curve = plain_solve(u0, spec, 0.0, 3 * SOLVE_EVERY)
        tol = (curve[1] + curve[2]) / 2
        want, n_want, r_want, _ = plain_solve(u0, spec, tol, 2000)
        (got, n, res), counts = counted(lambda: J.jacobi_solve(
            u0, tol=tol, max_iters=2000, check_every=SOLVE_EVERY,
            policy="rowchunk"))
        print(f"[{dname}] jacobi_solve(tol={tol:.6e}, check_every="
              f"{SOLVE_EVERY}, policy='rowchunk'): iters {n} (plain chain "
              f"{n_want}), residual {res:.6e} (plain {r_want:.6e}), "
              f"launches {counts}")
        check(n == n_want < 2000 and res == r_want
              and torch.equal(got, want),
              "jacobi_solve must realize the plain chain's iterations and "
              "equal it bit for bit")
        check(counts == {"shifted": 0, "rowchunk": n, "dbuf": 0,
                         "temporal": 0}
              and engine.ROWCHUNK_VARIANTS["jacobi5"] == n,
              f"jacobi_solve(rowchunk) must launch K2 once a sweep: "
              f"{counts}")
        if dname == "bfloat16":
            add_path(stats, "rowchunk", "jacobi_solve(rowchunk, "
                     "check_every=200)", n)

        for version, (policy, wrapper) in JACOBI_VERSIONS.items():
            kw = {"t": T} if policy == "temporal" else {}
            want = getattr(engine, f"stencil_{policy}")(u0, spec, **kw)
            old = getattr(legacy, wrapper)
            for label, call in ((f"ops.jacobi_step({version})",
                                 lambda: ops.jacobi_step(u0,
                                                         version=version)),
                                (old.__name__, lambda: old(u0))):
                with warnings.catch_warnings(record=True) as warned:
                    warnings.simplefilter("always")
                    got, counts = counted(call)
                deprecated = any(issubclass(w.category, DeprecationWarning)
                                 for w in warned)
                check(counts == {p: int(p == policy) for p in counts}
                      and torch.equal(got, want)
                      and deprecated == (label == old.__name__),
                      f"[{dname}] {label} must launch {policy} once, equal "
                      f"engine.stencil_{policy} and warn only if deprecated: "
                      f"{counts}")
                if dname == "bfloat16":
                    add_path(stats, policy, label, counts[policy])
        got, counts = counted(lambda: ops.jacobi_step(u0, version="ref"))
        check(sum(counts.values()) == 0
              and torch.equal(got, apply_stencil(u0, spec)),
              "ops.jacobi_step('ref') is the plain oracle and launches "
              "nothing")
        print(f"[{dname}] v0 / v1 / v1db / v2 (ops and the deprecated "
              f"wrappers) each launched its kernel once, bit for bit "
              f"engine.stencil_*; ref launched none")

    cmd = [sys.executable, "-m", "repro_torch.launch.solve", "--kernel",
           "v2", "--temporal", str(T), "--ny", str(NY), "--nx", str(NX),
           "--iters", str(ITERS), "--dtype", "bfloat16", "--check"]
    src = str(pathlib.Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=600)
    print(res.stdout.strip())
    check(res.returncode == 0 and "CHECK OK" in res.stdout
          and "temporal: 1003 sweeps = 125 x t=8 + 3 (rowchunk)"
          in res.stdout,
          f"{' '.join(cmd[1:])} failed: {res.stderr[-2000:]}")
    print(f"{' '.join(cmd[2:])}: CHECK OK in {time.perf_counter() - t0:.1f}s")

    for name, mod in (("quickstart", quickstart),
                      ("distributed_jacobi", distributed_jacobi),
                      ("serve_lm", serve_lm)):
        print(f"-- python -m repro_torch.examples.{name} (on the card) --")
        reset_all_launches()
        mod.main([])
        torch.cuda.synchronize()
        counts = {k: v for k, v in all_launches().items() if v}
        print(f"examples.{name}: launches {counts}")
        # serve_lm's 12-token prompts take no kernel of the port (its
        # smoke model attends by the plain path), only the card.
        check(bool(counts) or name == "serve_lm",
              f"examples.{name} launched no kernel")
    print(f"phase 15 on {smi}")


#: Decoders whose whole bf16 prefill logits, flash against jnp, are
#: printed and not gated: chatglm3-6b's jnp route alone is 9.0841e-02 over
#: the bound from its own f32 logits (measured on one H100), so no attention
#: kernel, however right, could keep the two bf16 routes within it. K8 is
#: gated at every layer on both routes' streams and the whole prefill in
#: f32 instead, as zamba2-7b's is in phase 11 (ROADMAP Queue 3).
WHOLE_BF16_UNGATED = {"chatglm3-6b"}


@torch.no_grad()
def layer_attention_gaps(model, ref, walk, toks: torch.Tensor) -> list:
    """Each layer's attention through ``model`` (K8) against ``ref`` (the
    same weights on the jnp route), fed ``walk``'s stream (one of the
    two). Returns the largest excess over 5e-2 * |ref| per layer."""
    from repro_torch.layers.attention import attention
    cfg = walk.cfg
    x = basic.embed(walk.embedding, toks, cfg)
    b, s = toks.shape
    pos = torch.arange(s, device=toks.device).expand(b, s)
    gaps = []
    for layer in walk.layers:
        h = basic.rms_norm(layer.ln1, x, cfg.norm_eps)
        got, _ = attention(layer.attn, h, pos, model.cfg)
        want, _ = attention(layer.attn, h, pos, ref.cfg)
        gaps.append(excess(got, want)[1])
        del got, want, h
        x = layer(x, pos, cfg)[0]
    return gaps


def gate_k8_routes(arch: str, model, eng, toks, got, stats) -> None:
    """K8 against the jnp route: the whole bf16 prefill logits (gated but
    for WHOLE_BF16_UNGATED), each layer's attention on both routes'
    streams, and the whole prefill in f32 compute (K8's split-TF32
    route), all at the JAX package's bound, rtol 5e-2 and atol 8e-2."""
    cfg = model.cfg

    def prefill(**kw):
        twin = model.with_config(dataclasses.replace(cfg, **kw))
        return ServeEngine(twin, batch_size=WAVE,
                           max_len=eng.max_len)._prefill(toks)[0]

    want = prefill(attn_impl="jnp")
    err, worst = excess(got, want)
    reset_all_launches()
    exact = prefill(dtype=torch.float32)
    torch.cuda.synchronize()
    f32_counts = dict(flash.LAUNCHES)
    exact_jnp = prefill(dtype=torch.float32, attn_impl="jnp")
    gaps = [excess(x, exact_jnp)[1] for x in (got, want)]
    ungated = arch in WHOLE_BF16_UNGATED
    print(f"prefill logits in bf16, flash vs jnp"
          f"{' (not a gate)' if ungated else ''}: max |diff| {err:.6e}, "
          f"largest excess over rtol*|jnp| {worst:.6e} (atol 8e-2), logit "
          f"range [{float(want.min()):.3f}, {float(want.max()):.3f}]; "
          f"against the f32 jnp logits, largest excess of flash (bf16) "
          f"{gaps[0]:.6e}, of jnp (bf16) {gaps[1]:.6e}")
    check(bool(got.isfinite().all()) and bool(want.isfinite().all())
          and (ungated or worst <= 8e-2),
          f"{arch}: flash prefill logits off the jnp path")
    jnp_model = model.with_config(dataclasses.replace(cfg, attn_impl="jnp"))
    for name, walk in (("flash", model), ("jnp", jnp_model)):
        layer_gaps = layer_attention_gaps(model, jnp_model, walk, toks)
        print(f"each layer's attention, flash vs jnp on the {name} route's "
              f"stream: largest excess over 5e-2*|jnp| "
              f"{max(layer_gaps):.4e} (atol 8e-2; layers "
              f"{', '.join(f'{w:.2e}' for w in layer_gaps)})")
        check(all(w <= 8e-2 for w in layer_gaps),
              f"{arch}: a layer's attention through K8 off the jnp path on "
              f"the {name} route's stream: {layer_gaps}")
    err, worst = excess(exact, exact_jnp)
    print(f"prefill logits in f32 compute, flash vs jnp: max |diff| "
          f"{err:.6e}, largest excess over rtol*|jnp| {worst:.6e} (atol "
          f"8e-2); K8 launches {f32_counts}")
    check(f32_counts == {"flash_attention": cfg.n_layers,
                         "flash_attention_wgmma": 0,
                         "flash_attention_tf32": cfg.n_layers}
          and bool(exact.isfinite().all()) and worst <= 8e-2,
          f"{arch}: the f32 prefill must launch the split-TF32 K8 once a "
          f"layer and agree with the jnp route")
    key = FLASH_TIMED.get((WAVE, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.hd))
    if key == "group16":
        stats["flash"][key]["float32"].update(
            launches=cfg.n_layers,
            path=f"ServeEngine._prefill({arch}, flash, float32)")


@torch.no_grad()
def mla_absorbed_vs_expanded(model) -> None:
    """minicpm3 in f32: a 256-token prompt and 16 decode steps through the
    absorbed path over the latent cache, against one forward of the same
    272 tokens by the expanded path, at every position."""
    cfg = model.cfg
    model = model.with_config(dataclasses.replace(cfg, dtype=torch.float32))
    g = torch.Generator("cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (WAVE, 272), generator=g,
                         device="cuda")
    full, _, _ = model.forward({"tokens": toks})
    cache = model.init_cache(WAVE, 272)
    first, cache, _ = model.forward({"tokens": toks[:, :256]}, cache)
    steps = [first]
    for i in range(256, 272):
        out, cache, _ = model.forward({"tokens": toks[:, i:i + 1]}, cache)
        steps.append(out)
    absorbed = torch.cat(steps, dim=1)
    diff = (absorbed - full).abs()
    worst = float((diff - 1e-3 * full.abs()).max())
    print(f"minicpm3 f32, absorbed (256-token prompt + 16 steps over the "
          f"latent cache) vs expanded (one 272-token forward): max |diff| "
          f"{float(diff.max()):.6e}, largest excess over 1e-3*|expanded| "
          f"{worst:.6e} (atol 1e-3), logit range [{float(full.min()):.3f}, "
          f"{float(full.max()):.3f}]")
    check(bool(absorbed.isfinite().all()) and worst <= 1e-3,
          "MLA's absorbed decode is off its expanded path in f32")


def serve_decoder(arch: str, smi: str, stats) -> None:
    cfg = dataclasses.replace(configs.get_config(arch), attn_impl="flash")
    attn = (f"MLA (q lora {cfg.q_lora_rank}, kv lora {cfg.kv_lora_rank}, "
            f"qk {cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim}, v "
            f"{cfg.v_head_dim})" if cfg.attn_type == "mla"
            else f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}")
    print(f"-- {cfg.name} at full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {attn}, vocab {cfg.vocab_size}), "
          f"attn_impl=flash, {WAVE} x {PROMPT} tokens + {NEW} new --")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.n_params(), "params != count_params")
    print(f"random init of {n_params} params in "
          f"{time.perf_counter() - t0:.1f}s")
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
    print(f"launches: { {k: v for k, v in counts.items() if v} }")
    want_k8 = 0 if cfg.attn_type == "mla" else cfg.n_layers
    check(counts["flash_attention"] == counts["flash_attention_wgmma"]
          == want_k8 and sum(counts.values()) == 2 * want_k8,
          f"{arch}: one prefill wave must launch K8 {want_k8} times (once "
          f"a layer, on the tensor-core kernel; MLA never) and nothing "
          f"else: {counts}")
    for i, r in enumerate(done):
        check(len(r.generated) == NEW
              and all(0 <= t < cfg.padded_vocab for t in r.generated),
              f"request {i}: {len(r.generated)} tokens, ids {r.generated}")
    print(f"req0 -> {done[0].generated[:8]} ...; every request got {NEW} "
          f"tokens in [0, {cfg.padded_vocab})")
    toks = torch.from_numpy(prompts.astype(np.int64)).cuda()
    got, cache = eng._prefill(toks)
    if want_k8:
        path = f"ServeEngine.generate({arch}, flash)"
        stats["flash"].setdefault("paths", {})[path] = want_k8
        key = FLASH_TIMED.get((WAVE, PROMPT, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd))
        if key == "group16":
            stats["flash"][key]["bfloat16"].update(launches=want_k8,
                                                   path=path)
        gate_k8_routes(arch, model, eng, toks, got, stats)
    if cfg.family == "vlm":
        img = torch.randn((WAVE, cfg.vlm_image_tokens, cfg.vlm_vision_dim),
                          generator=torch.Generator("cuda").manual_seed(3),
                          device="cuda")
        reset_all_launches()
        with torch.no_grad():
            logits, _, _ = model.forward(
                {"tokens": toks[:, :PROMPT - cfg.vlm_image_tokens],
                 "image_embeds": img}, last_only=True)
        torch.cuda.synchronize()
        check(logits.shape == (WAVE, 1, cfg.padded_vocab)
              and bool(logits.isfinite().all())
              and flash.LAUNCHES["flash_attention_wgmma"] == cfg.n_layers,
              f"{arch}: a forward with {cfg.vlm_image_tokens} image "
              f"embeddings must launch K8 once a layer")
        print(f"forward with {cfg.vlm_image_tokens} image embeddings ahead "
              f"of {PROMPT - cfg.vlm_image_tokens} tokens: finite logits, "
              f"K8 {flash.LAUNCHES['flash_attention_wgmma']} launches")
    if cfg.attn_type == "mla":
        mla_absorbed_vs_expanded(model)
    print(f"params={n_params} on {smi}")
    time_serving(eng, toks, cache, done, requests, first, peak, smi)


def phase_decoders(smi: str, stats) -> None:
    print("== phase 16: chatglm3-6b, internvl2-2b and minicpm3-4b at full "
          "width ==")
    for arch in ("chatglm3-6b", "internvl2-2b", "minicpm3-4b"):
        serve_decoder(arch, smi, stats)
        gc.collect()
        torch.cuda.empty_cache()


MOE_ARCH, ENC_ARCH, TRAIN_ARCH = ("qwen3-moe-30b-a3b", "hubert-xlarge",
                                  "qwen2.5-3b")
ENC_B, ENC_S = 8, 1024
# The bound of the full-width MoE layer on the card (bf16 compute, bf16
# storage) against the same layer on the CPU in f32: max |diff| within
# this share of the CPU output's largest magnitude (the outputs reach tens
# at random init, so an absolute bound would not do).
MOE_LAYER_SHARE = 2e-2
# accum=2 against accum=1 (bf16 compute): each gradient tensor within
# this share of its largest element.
ACCUM_SHARE = 5e-2


def moe_layer_vs_cpu(model, cfg) -> None:
    """Layer 0's MoE at full width on one group of 256 tokens: on the card
    in bf16 against the same parameters and inputs on the CPU in f32."""
    layer = model.layers[0].ffn
    g = torch.Generator("cuda").manual_seed(7)
    x = torch.randn((1, 256, cfg.d_model), generator=g, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        got, aux = moe_ffn(layer, x, cfg)
        cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                      param_dtype=torch.float32)
        cpu = MoE(ParamInit(cpu_cfg, device="meta"),
                  cpu_cfg).to_empty(device="cpu").requires_grad_(False)
        for name, p in cpu.named_parameters():
            p.copy_(getattr(layer, name).float().cpu())
        t0 = time.perf_counter()
        want, want_aux = moe_ffn(cpu, x.float().cpu(), cpu_cfg)
        cpu_s = time.perf_counter() - t0
    diff = float((got.float().cpu() - want).abs().max())
    share = diff / float(want.abs().max())
    print(f"one MoE layer (group of 256 tokens, capacity "
          f"{capacity(256, cfg)}), card bf16 vs CPU f32: max |diff| "
          f"{diff:.6e} = {share:.3e} of max |cpu| (bound "
          f"{MOE_LAYER_SHARE}), output range "
          f"[{float(want.min()):.3f}, {float(want.max()):.3f}]; "
          f"moe_drop_frac card {float(aux['moe_drop_frac']):.6f} cpu "
          f"{float(want_aux['moe_drop_frac']):.6f}; lb {float(aux['moe_lb_loss']):.6f}"
          f" / {float(want_aux['moe_lb_loss']):.6f}; the CPU layer {cpu_s:.1f}s")
    check(bool(got.isfinite().all()) and share <= MOE_LAYER_SHARE,
          f"the full-width MoE layer on the card is off the CPU f32 layer: "
          f"{share} of max |cpu|")


def phase_moe(smi: str, stats) -> None:
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH), attn_impl="flash",
                              param_dtype=torch.bfloat16)
    print(f"== phase 17: MoE serving, {cfg.name} at full width ({cfg.n_layers}"
          f" layers, d {cfg.d_model}, {cfg.n_experts} experts of ff "
          f"{cfg.d_ff}, top {cfg.experts_per_token}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.hd}), bf16 storage, "
          f"attn_impl=flash, {WAVE} x {PROMPT} tokens + {NEW} new ==")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.n_params()
          and all(p.dtype == torch.bfloat16 for p in model.parameters()),
          "params != count_params, or not all stored in bf16")
    print(f"random init of {n_params} params (bf16, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(4)
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
    print(f"launches: { {k: v for k, v in counts.items() if v} }")
    check(counts["flash_attention"] == counts["flash_attention_wgmma"]
          == cfg.n_layers and sum(counts.values()) == 2 * cfg.n_layers,
          f"one prefill wave must launch K8 once a layer ({cfg.n_layers}), "
          f"on the tensor-core kernel, and nothing else: {counts}")
    path = f"ServeEngine.generate({MOE_ARCH}, flash)"
    stats["flash"].setdefault("paths", {})[path] = cfg.n_layers
    stats["flash"]["group8"]["bfloat16"].update(launches=cfg.n_layers,
                                                path=path)
    for i, r in enumerate(done):
        check(len(r.generated) == NEW
              and all(0 <= t < cfg.padded_vocab for t in r.generated),
              f"request {i}: {len(r.generated)} tokens, ids {r.generated}")
    print(f"req0 -> {done[0].generated[:8]} ...; every request got {NEW} "
          f"tokens in [0, {cfg.padded_vocab})")
    toks = torch.from_numpy(prompts.astype(np.int64)).cuda()
    got, cache = eng._prefill(toks)
    with torch.no_grad():
        _, _, aux = model.forward({"tokens": toks}, model.init_cache(
            WAVE, eng.max_len), last_only=True)
        step = torch.from_numpy(np.asarray([[r.generated[0]] for r in done],
                                           np.int64)).cuda()
        _, _, daux = model.forward({"tokens": step}, cache)
    print(f"moe_drop_frac: prefill {float(aux['moe_drop_frac']):.6f} (groups "
          f"of {cfg.moe_group_size}, capacity {capacity(cfg.moe_group_size, cfg)}), "
          f"decode step {float(daux['moe_drop_frac']):.6f} (a group of "
          f"{WAVE} tokens, capacity {capacity(WAVE, cfg)}); lb "
          f"{float(aux['moe_lb_loss']):.4f}, z {float(aux['moe_z_loss']):.4f}")
    jnp_model = model.with_config(dataclasses.replace(cfg, attn_impl="jnp"))
    for name, walk in (("flash", model), ("jnp", jnp_model)):
        layer_gaps = layer_attention_gaps(model, jnp_model, walk, toks)
        print(f"each layer's attention, flash vs jnp on the {name} route's "
              f"stream: largest excess over 5e-2*|jnp| "
              f"{max(layer_gaps):.4e} (atol 8e-2; layers "
              f"{', '.join(f'{w:.2e}' for w in layer_gaps)})")
        check(all(w <= 8e-2 for w in layer_gaps),
              f"{MOE_ARCH}: a layer's attention through K8 off the jnp path "
              f"on the {name} route's stream: {layer_gaps}")
    moe_layer_vs_cpu(model, cfg)
    print(f"params={n_params} on {smi}")
    time_serving(eng, toks, cache, done, requests, first, peak, smi)


@torch.no_grad()
def encoder_attention_gaps(model, ref, walk, feats: torch.Tensor) -> list:
    """Each encoder layer's attention through ``model`` (K8) against
    ``ref`` (the jnp route), fed ``walk``'s stream. Returns the largest
    excess over 5e-2 * |ref| per layer."""
    from repro_torch.layers.attention import attention
    cfg = walk.cfg
    x = walk.feature_proj(feats, cfg.dtype)
    b, s = feats.shape[:2]
    pos = torch.arange(s, device=feats.device).expand(b, s)
    gaps = []
    for layer in walk.layers:
        h = basic.layer_norm(layer.ln1, x, cfg.norm_eps)
        got, _ = attention(layer.attn, h, pos, model.cfg)
        want, _ = attention(layer.attn, h, pos, ref.cfg)
        gaps.append(excess(got, want)[1])
        del got, want, h
        x = layer(x, pos, cfg)
    return gaps


def timed_steps(step, state, batch, n: int):
    """``n`` train steps on ``batch``: (state, ce of each, ms of each)."""
    ces, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        ces.append(float(metrics["ce"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, ces, ms


def profile_step(label: str, step, state, batch, wall: float) -> None:
    """Where one train step's device time goes: its kernels' total against
    the median wall ``wall`` of the steps just timed, and the kernels with
    the most time (the profiled call takes one more step)."""
    kernels = top_kernels(lambda: step(state, batch), n=1 << 30)
    dev = sum(ms for _, ms, _ in kernels)
    print(f"{label}: one step's kernels {dev:.3f} ms in "
          f"{sum(n for _, _, n in kernels)} kernels (busy {dev / wall:.1%} "
          f"of the median step wall {wall:.1f} ms); the kernels with the "
          f"most device time:")
    for name, ms, count in kernels[:8]:
        print(f"  {ms:10.3f} ms {count:5d}x  {name[:100]}")


def phase_encoder(smi: str, stats) -> None:
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainstep import init_state, make_train_step
    # S 1024 is not past the config's attn_chunk of 1024, where both
    # packages attend in one block and K8 never runs. The forward's gates
    # cut attn_chunk to 512, so both routes take the long path; the AdamW
    # steps run at the config's own attn_chunk.
    own = configs.get_config(ENC_ARCH)
    cfg = dataclasses.replace(own, attn_chunk=512)
    print(f"== phase 18: the encoder, {cfg.name} at full width "
          f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.hd}, non-causal), frames B {ENC_B} x S {ENC_S} x "
          f"{cfg.audio_feat_dim}, attn_chunk {cfg.attn_chunk} for the "
          f"forward's gates, {own.attn_chunk} for the AdamW steps ==")
    model = build_model(own, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.n_params(), "params != count_params")
    jnp_model = model.with_config(cfg)
    g = torch.Generator("cuda").manual_seed(8)
    batch = {"features": torch.randn((ENC_B, ENC_S, cfg.audio_feat_dim),
                                     generator=g, device="cuda"),
             "labels": torch.randint(0, cfg.vocab_size, (ENC_B, ENC_S),
                                     generator=g, device="cuda")}
    flash_model = model.with_config(dataclasses.replace(cfg,
                                                        attn_impl="flash"))
    reset_all_launches()
    with torch.no_grad():
        logits, _, _ = flash_model.forward(batch)
    torch.cuda.synchronize()
    counts = all_launches()
    print(f"{n_params} params; the flash forward's launches: "
          f"{ {k: v for k, v in counts.items() if v} }")
    check(logits.shape == (ENC_B, ENC_S, cfg.padded_vocab)
          and bool(logits.isfinite().all())
          and counts["flash_attention"] == counts["flash_attention_wgmma"]
          == cfg.n_layers and sum(counts.values()) == 2 * cfg.n_layers,
          f"the encoder's flash forward must launch K8 (hd 80, non-causal) "
          f"once a layer and nothing else: {counts}")
    path = f"{ENC_ARCH}.forward(flash, B={ENC_B}, S={ENC_S})"
    stats["flash"].setdefault("paths", {})[path] = cfg.n_layers
    stats["flash"]["hubert"]["bfloat16"].update(launches=cfg.n_layers,
                                                path=path)
    for name, walk in (("flash", flash_model), ("jnp", jnp_model)):
        gaps = encoder_attention_gaps(flash_model, jnp_model, walk,
                                      batch["features"])
        print(f"each layer's attention, flash vs jnp on the {name} route's "
              f"stream: largest excess over 5e-2*|jnp| {max(gaps):.4e} "
              f"(atol 8e-2)")
        check(all(w <= 8e-2 for w in gaps),
              f"{ENC_ARCH}: a layer's attention through K8 off the jnp path "
              f"on the {name} route's stream: {gaps}")
    with torch.no_grad():
        want, _, _ = jnp_model.forward(batch)
    err, worst = excess(logits, want)
    print(f"frame logits, flash vs jnp: max |diff| {err:.6e}, largest excess "
          f"over rtol*|jnp| {worst:.6e} (printed, not gated)")
    del logits, want
    opt = O.adamw(O.warmup_cosine(1e-4, 1, 10))
    step = make_train_step(model, opt)
    state = init_state(model, opt)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    state, ces, ms = timed_steps(step, state, batch, 4)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"AdamW with remat {own.remat}: ce {', '.join(f'{c:.4f}' for c in ces)}; "
          f"ms a step {', '.join(f'{m:.1f}' for m in ms)} (first includes "
          f"the moments' allocation); peak {peak:.2f} GiB; kernel launches "
          f"{sum(all_launches().values())}; on {smi}")
    check(all(np.isfinite(ces)) and sum(all_launches().values()) == 0,
          "the encoder's training steps must give finite losses and launch "
          "no kernel")
    profile_step(f"{ENC_ARCH} AdamW step", step, state, batch,
                 float(np.median(ms[1:])))


def full_width_profile() -> None:
    """The CLI's step in this process (qwen2.5-3b at full width, AdamW with
    its schedule, a batch of 8 x 128 from the synthetic corpus): two steps
    timed, then one profiled."""
    from repro_torch.train import optimizer as O
    from repro_torch.train.data import DataConfig, make_pipeline
    from repro_torch.train.trainstep import init_state, make_train_step
    cfg = configs.get_config(TRAIN_ARCH)
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    opt = O.adamw(O.warmup_cosine(3e-3, 3, 20))
    step = make_train_step(model, opt)
    b = next(make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                      global_batch=8)).batches())
    batch = {k: torch.from_numpy(b[k]).long().cuda()
             for k in ("tokens", "labels")}
    state, _, ms = timed_steps(step, init_state(model, opt), batch, 3)
    profile_step(f"{TRAIN_ARCH} at full width, AdamW step", step, state,
                 batch, float(np.median(ms[1:])))
    del model, state
    gc.collect()
    torch.cuda.empty_cache()


def train_cli(*args: str, ckpt: str, steps: int = 10,
              **popen) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--batch", "8", "--seq", "128", "--steps", str(steps),
         "--ckpt-dir", ckpt, *args], cwd=ROOT, env=env, text=True, **popen)


def run_cli(*args: str, ckpt: str, timeout: int = 600,
            steps: int = 10) -> str:
    proc = train_cli(*args, ckpt=ckpt, steps=steps, stdout=subprocess.PIPE,
                     stderr=subprocess.PIPE)
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"launch.train {args} exited "
          f"{proc.returncode}: {err[-2000:]}")
    return out


def cli_numbers(out: str):
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    ces = [float(line.split("ce=")[1].split()[0]) for line in steps]
    ms = [float(line.split()[-2]) for line in steps]
    digest = [line for line in out.splitlines()
              if line.startswith("state digest=")][0].split("=")[1]
    return ces, ms, digest


def layer_cfg(arch: str):
    """Full width, cut to 2 layers (zamba2: one group of its period behind
    the shared block, and one tail layer)."""
    cfg = configs.get_config(arch)
    layers = cfg.hybrid_period + 1 if cfg.family == "hybrid" else 2
    return dataclasses.replace(cfg, n_layers=layers)


def family_batch(cfg, seed: int, b: int = 2, s: int = 256) -> dict:
    g = torch.Generator("cuda").manual_seed(seed)
    batch = {"labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device="cuda")}
    if cfg.family == "encoder":
        batch["features"] = torch.randn((b, s, cfg.audio_feat_dim),
                                        generator=g, device="cuda")
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=g, device="cuda")
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (b, cfg.vlm_image_tokens, cfg.vlm_vision_dim), generator=g,
            device="cuda")
    return batch


def train_families(smi: str) -> None:
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainstep import init_state, loss_and_grads
    for arch in ("qwen2.5-3b", "chatglm3-6b", "minicpm3-4b", "internvl2-2b",
                 MOE_ARCH, "mamba2-2.7b", "zamba2-7b", ENC_ARCH,
                 "deepseek-7b"):
        cfg = layer_cfg(arch)
        model = build_model(cfg, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
        opt = O.adamw(1e-4)
        state = init_state(model, opt)
        batch = family_batch(cfg, seed=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, grads = loss_and_grads(model, state.params, batch)
        finite = all(bool(g.isfinite().all()) for g in grads.values())
        opt.update_(grads, state.opt_state, state.params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = sum(p.numel() for p in model.parameters())
        print(f"{arch:20s} {cfg.n_layers} layers, {n} params: one AdamW step "
              f"{ms:.1f} ms, ce {float(metrics['ce']):.4f}, grads finite "
              f"{finite}"
              + (f", moe_drop_frac {float(metrics['moe_drop_frac']):.4f}"
                 if "moe_drop_frac" in metrics else ""))
        check(finite and bool(np.isfinite(float(metrics["ce"])))
              and all(p.isfinite().all() for p in state.params.values()),
              f"{arch}: a training step's loss, grads or parameters are not "
              f"finite")
        del model, state, grads, metrics
        gc.collect()
        torch.cuda.empty_cache()


def checkpoint_rates(state, ckpt_dir: str) -> None:
    """Time a synchronous checkpoint of ``state`` (the host copy and the
    write) and its restore, and price a full-width state by them (phase
    19 times the parameters of its 2-layer state, a third of the state's
    bytes: the rate, not the whole state, is what it reads)."""
    import shutil
    from repro_torch.train import checkpoint as ckpt
    t0 = time.perf_counter()
    path = pathlib.Path(ckpt.save(ckpt_dir, 0, state))
    save_s = time.perf_counter() - t0
    gb = sum(f.stat().st_size for f in path.iterdir()) / 1e9
    t0 = time.perf_counter()
    ckpt.restore(ckpt_dir, 0, state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    full = configs.get_config(TRAIN_ARCH).n_params() * 12 / 1e9
    print(f"a synchronous checkpoint of these tensors: {gb:.2f} GB saved in "
          f"{save_s:.1f} s ({gb / save_s:.2f} GB/s with the host copy), "
          f"restored in {load_s:.1f} s ({gb / load_s:.2f} GB/s); "
          f"{shutil.disk_usage(ckpt_dir).free / 1e9:.1f} GB free on its "
          f"disk; a full-width {TRAIN_ARCH} state (f32 params and two "
          f"moments, {full:.1f} GB) would take ~{full * save_s / gb:.0f} s "
          f"to save")
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def train_gates(tmp: str) -> None:
    """At full width and 2 layers: accumulation, an injected failure and
    K8/K7's refusal of a gradient on the card."""
    from repro_torch.train import optimizer as O
    from repro_torch.train.fault import FaultConfig, FaultTolerantRunner
    from repro_torch.train.trainstep import (init_state, loss_and_grads,
                                             make_train_step)
    cfg = layer_cfg(TRAIN_ARCH)
    # Deterministic algorithms: the embedding's backward otherwise sums
    # with atomics, and two runs of the same steps may differ in the
    # last bits. The variable below only satisfies the mode's check:
    # cuBLAS fixed its workspace when earlier phases made its handles.
    # cuBLAS is deterministic here because every step runs on one stream
    # (launch.train sets the variable before any work on the card).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3))
    params = dict(model.named_parameters())
    batch = family_batch(cfg, seed=4, b=8, s=128)
    _, g1 = loss_and_grads(model, params, batch, 1)
    _, g2 = loss_and_grads(model, params, batch, 2)
    shares = {k: float((g1[k] - g2[k]).abs().max() / g1[k].abs().max())
              for k in g1}
    name = max(shares, key=shares.get)
    print(f"accum=2 vs accum=1 ({TRAIN_ARCH}, {cfg.n_layers} layers, batch "
          f"8 x 128): largest max|diff| / max|g| {shares[name]:.3e} "
          f"({name}; bound {ACCUM_SHARE})")
    check(shares[name] <= ACCUM_SHARE, "accum=2 is off accum=1")
    del g1, g2

    opt = O.adamw(1e-4)
    # 4 steps: the failure at step 3 restores the one checkpoint, step 2's
    # (each is 5.6 GB at this width).
    data = [family_batch(cfg, seed=10 + i, b=8, s=128) for i in range(4)]
    step = make_train_step(model, opt)
    clean = FaultTolerantRunner(step, init_state(model, opt), FaultConfig(
        ckpt_dir=os.path.join(tmp, "clean"), ckpt_every=100)).run(data, 4)
    want = state_digest(clean)
    checkpoint_rates(clean.params, os.path.join(tmp, "timed"))
    del clean
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3))
    inner = make_train_step(model, opt)
    left = [1]

    def flaky(state, batch):
        if int(state.opt_state.step) == 3 and left[0]:
            left[0] -= 1
            raise RuntimeError("injected device failure")
        return inner(state, batch)

    runner = FaultTolerantRunner(flaky, init_state(model, opt), FaultConfig(
        ckpt_dir=os.path.join(tmp, "flaky"), ckpt_every=2))
    got = state_digest(runner.run(data, 4))
    print(f"an injected failure at step 3 (checkpoint of step 2 restored, "
          f"the step retried): restores {runner.restores}, final state "
          f"digest {got} vs the clean run's {want}")
    check(runner.restores == 1 and got == want,
          "the run with an injected failure must end in the clean run's state")
    torch.use_deterministic_algorithms(False)
    del runner, model
    gc.collect()
    torch.cuda.empty_cache()

    q = torch.randn((1, 256, 4, 80), device="cuda", requires_grad=True)
    k = torch.randn((1, 256, 4, 80), device="cuda")
    x = torch.randn((1, 64, 32), device="cuda")
    w = torch.randn((4, 32), device="cuda", requires_grad=True)
    refused = []
    reset_all_launches()
    for what, fn in (("K8", lambda: flash.flash_attention_local(q, k, k)),
                     ("K7", lambda: conv.conv1d_depthwise_causal(x, w))):
        try:
            fn()
        except flash.GradientError:
            refused.append(what)
    print(f"under grad on the card, refused: {refused}; launches "
          f"{sum(all_launches().values())}")
    check(refused == ["K8", "K7"] and sum(all_launches().values()) == 0,
          "K8 and K7 must refuse a gradient on the card before launching")


def kill_and_resume(tmp: str) -> None:
    """At 2 layers: a run killed once its step-5 checkpoint is on disk,
    resumed with ``--resume auto``, must end in the uninterrupted run's
    state bit for bit."""
    gate = ("--layers", "2", "--deterministic")
    # The uninterrupted run and the run to kill go side by side (each is
    # deterministic alone); the resumed run follows the kill.
    whole = train_cli(*gate, "--ckpt-every", "20",
                      ckpt=os.path.join(tmp, "a"), stdout=subprocess.PIPE,
                      stderr=subprocess.PIPE)
    ckpt_b = os.path.join(tmp, "b")
    first = pathlib.Path(ckpt_b) / "step_00000005"
    child = train_cli(*gate, "--ckpt-every", "5", ckpt=ckpt_b,
                      stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    t0 = time.perf_counter()
    while not first.exists() and child.poll() is None \
            and time.perf_counter() - t0 < 600:
        time.sleep(0.01)
    child.kill()
    child.wait()
    out, err = whole.communicate(timeout=600)
    check(whole.returncode == 0, f"launch.train {gate} exited "
          f"{whole.returncode}: {err[-2000:]}")
    full = cli_numbers(out)
    check(first.exists(), "the run to kill wrote no checkpoint")
    resumed = run_cli(*gate, "--ckpt-every", "20", "--resume", "auto",
                      ckpt=ckpt_b)
    again = cli_numbers(resumed)
    from_step = [line for line in resumed.splitlines()
                 if line.startswith("resumed from step")]
    print(f"killed after its checkpoint of step 5 appeared; {from_step}; "
          f"resumed digest {again[2]} vs uninterrupted {full[2]}; resumed "
          f"ce {again[0]} vs {full[0][-len(again[0]):]}")
    check(bool(from_step) and again[2] == full[2],
          "the resumed run must end in the uninterrupted run's state "
          "(deterministic algorithms)")


def phase_train(smi: str, stats) -> None:
    import shutil
    import tempfile
    print(f"== phase 19: training, {TRAIN_ARCH} through launch.train at full "
          f"width, accumulation, resume and failure gates at 2 layers, one "
          f"step of each family, the example twins ==")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    reset_all_launches()
    parts: dict = {}
    mark = [time.perf_counter()]

    def part(name):  # the seconds since the last mark, printed at the end
        now = time.perf_counter()
        parts[name] = round(now - mark[0], 1)
        mark[0] = now

    # Full width and depth, the reference launcher's defaults but 5 steps
    # (the first step's warm-up, then a few to read: this phase is the
    # script's longest). A checkpoint of this state (params + two
    # moments, ~37 GB) would take about a minute to write, and three
    # exceed the disk: checkpoints are gated at 2 layers below.
    out = run_cli("--ckpt-every", "20", ckpt=os.path.join(tmp, "full"),
                  timeout=900, steps=5)
    ces, ms, _ = cli_numbers(out)
    print("\n".join(line for line in out.splitlines()
                    if not line.startswith("state digest")))
    check(len(ces) == 5 and all(np.isfinite(ces)),
          f"the full-width run must report 5 finite losses: {ces}")
    part("full-width CLI")
    full_width_profile()
    part("full-width profile")

    # The example twins start here and run beside the kill-and-resume
    # gate's processes (both are gates, neither is timed); they are
    # collected before the in-process gates, whose checkpoint is timed.
    t_examples = time.perf_counter()
    examples = {example: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{example}",
         *(["--ckpt-dir", os.path.join(tmp, "ft")]
           if example.startswith("fault") else [])],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for example in ("train_lm", "fault_tolerant_training")}
    try:
        kill_and_resume(tmp)
        for example, proc in examples.items():
            out, err = proc.communicate(timeout=600)
            print(f"examples.{example}: exit {proc.returncode} (beside the "
                  f"kill-and-resume gate, done by "
                  f"{time.perf_counter() - t_examples:.1f}s); "
                  f"{out.strip().splitlines()[-1] if out else ''}")
            check(proc.returncode == 0, f"{example} failed: {err[-2000:]}")
    finally:  # a failed gate leaves no example running
        for proc in examples.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    part("kill and resume, examples")
    train_gates(tmp)
    part("gates")
    train_families(smi)
    part("families")
    check(sum(all_launches().values()) == 0,
          f"training launched a kernel: {all_launches()}")
    print(f"phase 19 parts, s: {json.dumps(parts)}")
    shutil.rmtree(tmp, ignore_errors=True)


# Phase 20: the dry run and the roofline, and the sharded LM pieces on an
# in-process mesh. The dry run counts on ``meta`` and needs no card, so it
# starts in worker processes when the script starts (at a lower priority)
# and runs beside phases 3-19; the archs are dealt to the workers by the
# seconds their cells took to count on a CPU (train cells dominate).
DRYRUN_DIR = ROOT / dryrun.OUTDIR
# The partitioned count of a full-width train cell takes 100-130 s on a
# CPU (qwen2.5-3b on pod, qwen3-moe-30b-a3b on multipod): the 80 cells
# take longer than phase 20a waits, so the workers count a subset, each
# worker's cells "arch/shape/mesh" in turn.
DRYRUN_WORKERS = [
    ("qwen2.5-3b/train_4k/pod", "hubert-xlarge/train_4k/pod"),
    ("qwen3-moe-30b-a3b/train_4k/multipod", "mamba2-2.7b/train_4k/pod"),
    ("qwen2.5-3b/prefill_32k/pod", "qwen2.5-3b/decode_32k/pod",
     "internvl2-2b/prefill_32k/pod", "deepseek-7b/decode_32k/pod",
     "chatglm3-6b/decode_32k/pod", "minicpm3-4b/train_4k/pod"),
    ("mamba2-2.7b/long_500k/pod", "qwen3-moe-30b-a3b/decode_32k/pod",
     "minicpm3-4b/prefill_32k/pod", "zamba2-7b/prefill_32k/pod",
     "hubert-xlarge/prefill_32k/pod",
     "qwen3-moe-30b-a3b/decode_32k/multipod"),
]
DRYRUN_CELLS = [c for cells in DRYRUN_WORKERS for c in cells]
# The card's published rates, ``gpu_sm90``'s constants (H100 SXM data
# sheet: dense bf16 tensor cores, HBM3), not measurements.
HW = get_device("gpu_sm90")


def start_dryrun() -> tuple[float, list]:
    """Start the dry run's workers: the cells of ``DRYRUN_WORKERS`` under
    gpu_sm90, partitioned on meta, each record written anew; (start
    time, the processes)."""
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, cells in enumerate(DRYRUN_WORKERS):
        log = open(DRYRUN_DIR / f"worker{i}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--device-model", "gpu_sm90", "--outdir", str(DRYRUN_DIR),
               "--force"]
        for cell in cells:
            cmd += ["--cell", cell]
        procs.append((subprocess.Popen(
            cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     CUDA_VISIBLE_DEVICES=""),
            preexec_fn=lambda: os.nice(10)), log))
    return time.perf_counter(), procs


def phase_dryrun(dry, smi: str) -> None:
    t0, procs = dry
    waited = time.perf_counter()
    for proc, log in procs:
        rc = proc.wait(timeout=420)
        log.close()
        check(rc == 0, f"a dry-run worker exited {rc}: "
              f"{pathlib.Path(log.name).read_text()[-2000:]}")
    done = time.perf_counter()
    recs = dry_report.load(str(DRYRUN_DIR))
    got = sorted(f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in recs)
    check(got == sorted(DRYRUN_CELLS), f"dry-run records {got} != the "
          f"cells asked for {sorted(DRYRUN_CELLS)}")
    family = {r["arch"]: configs.get_config(r["arch"]).family for r in recs}
    errors = [r for r in recs if r["status"] == "error"]
    by_family: dict = {}
    for r in errors:
        by_family.setdefault(family[r["arch"]], []).append(
            f"{r['arch']}/{r['shape']}/{r['mesh']}")
    print(f"== phase 20a: the partitioned dry run, {len(recs)} cells of the "
          f"80 ({', '.join(DRYRUN_CELLS)}), each on DTensors over the "
          f"production mesh's fake group, counted on meta, priced by "
          f"gpu_sm90's published 989 TFLOP/s (bf16 dense), 3.35 TB/s "
          f"(HBM3) and 450 GB/s a direction (NVLink); {len(procs)} workers "
          f"beside phases 3-19: {done - t0:.1f}s from their start, "
          f"{done - waited:.1f}s waited here; counting "
          f"{sum(r.get('count_s', 0) for r in recs):.1f}s in all; "
          f"{len(errors)} errors, by family "
          f"{ {k: len(v) for k, v in by_family.items()} } ==")
    for r in errors:
        print(f"[error] {r['arch']} {r['shape']} {r['mesh']} "
              f"({family[r['arch']]}): {r['error'][:300]}")
    check(not errors, f"dry-run errors: {by_family}")
    for r in recs:
        if r["status"] != "ok":
            continue
        rl, cost = r["roofline"], r["cost"]
        check(rl["collective_s"] is not None and rl["coll_bytes"] > 0,
              f"{r['arch']} {r['shape']}: no collective term {rl}")
        print(f"[{r['arch']} {r['shape']} {r['mesh']}] per device: "
              f"compute_s {rl['compute_s']:.6e} memory_s "
              f"{rl['memory_s']:.6e} collective_s {rl['collective_s']:.6e} "
              f"({rl['dominant']}); collective bytes by op "
              f"{ {k: int(v) for k, v in cost['collective_by_op'].items()} }"
              f" ({cost['collective_count']} ops, cross-pod "
              f"{rl['cross_pod_bytes']}); mesh device type "
              f"{r['mesh_device_type']}; counted in {r['count_s']}s")
    moe = next(r for r in recs if r["arch"] == "qwen3-moe-30b-a3b"
               and r["mesh"] == "multipod")
    check(moe["roofline"]["cross_pod_bytes"] > 0,
          f"qwen3-moe-30b-a3b train_4k on multipod: no cross-pod bytes")
    for mesh in sorted({r["mesh"] for r in recs}):
        print(f"-- roofline, {mesh} mesh --")
        print(dry_report.roofline_table(recs, mesh))
    print(dry_report.dryrun_table(recs))
    print(f"(the dry run's numbers are counted, not measured; {smi})")


def fill_kv(cache, length: int, seed: int):
    """The KV cache's buffers filled with random keys and values, its first
    ``length`` entries counted as written."""
    g = torch.Generator("cuda").manual_seed(seed)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda") * 0.5)
    return cache._replace(length=length)


def measured_cell(arch: str, shape: str, cell, reduced: list, smi: str,
                  rows: list, *, attn_impl: str = "jnp", fill=None):
    """Run one cell on the card (counted first on meta at the same shapes)
    and print its time, memory and roofline share; returns its launches
    and the counter's cost."""
    card_mesh = make_mesh((1, 1), ("data", "model"))
    cfg0 = configs.get_config(arch)
    cfg, knobs = tuning.tuned(cfg0, shape, card_mesh)
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if cell.kind == "train":
        reduced = reduced + [f"accum_steps {knobs.accum_steps} -> 1"]
        knobs = dataclasses.replace(knobs, accum_steps=1)
    cost, mem = dryrun.count_cell(cfg, cell, None, knobs)
    g = torch.Generator("cuda").manual_seed(0)
    model = build_model(cfg, device="cuda", generator=g)
    batch = dryrun.cell_inputs(cfg, cell, "cuda", g)
    cache = None
    if cell.kind == "decode":
        cache = model.init_cache(cell.global_batch, cell.seq_len)
        if fill is not None:
            cache = fill(cache)
    run, _, _ = dryrun.cell_program(model, cell, knobs, batch, cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    first = out if isinstance(out, torch.Tensor) else out[0]
    if cell.kind == "train":
        first = out[1]["ce"]
    check(bool(torch.isfinite(first.float()).all()),
          f"{arch} {shape}: non-finite output")
    kernels = {k: v for k, v in launches.items()
               if k not in ("flash_attention_wgmma", "flash_attention_tf32")}
    check(kernels == cost.kernels, f"{arch} {shape}: the card's launches "
          f"{launches} != the counter's {cost.kernels}")
    ms = wall_ms(run, reps=3)
    peak = torch.cuda.max_memory_allocated()
    rl = roofline.analyze(cost, 1, dryrun.model_flops(cfg0, cell), hw=HW,
                          partitioned=False)
    share = rl.bound_s * 1e3 / ms
    print(f"[{arch} {shape}] {cell.global_batch} x {cell.seq_len} "
          f"({cell.kind}; reduced: {reduced or 'none'}); attn_impl="
          f"{attn_impl}: median {ms:.3f} ms (wall, 3 runs); peak "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated) vs the counter's "
          f"{mem['total_nonalias'] / 2**30:.2f} GiB (args "
          f"{mem['argument_size_in_bytes'] / 2**30:.2f}, temp "
          f"{mem['temp_size_in_bytes'] / 2**30:.2f}); counted "
          f"{cost.dot_flops:.6e} dot FLOPs, {cost.hbm_proxy_bytes:.6e} "
          f"proxy bytes, kernels {cost.kernels}, launched {launches}; "
          f"gpu_sm90 (published peaks) compute_s {rl.compute_s:.6e} "
          f"memory_s {rl.memory_s:.6e} bound_s {rl.bound_s:.6e} "
          f"({rl.dominant}); bound/measured {share:.4f}; on {smi}")
    rows.append({"arch": arch, "shape": shape, "batch": cell.global_batch,
                 "seq": cell.seq_len, "reduced": reduced, "ms": ms,
                 "peak_gib": peak / 2**30,
                 "counted_gib": mem["total_nonalias"] / 2**30,
                 "flops": cost.dot_flops, "bytes": cost.hbm_proxy_bytes,
                 "compute_s": rl.compute_s, "memory_s": rl.memory_s,
                 "bound_s": rl.bound_s, "dominant": rl.dominant,
                 "share": share, "launches": launches})
    del model, batch, cache, run, out, first
    gc.collect()
    torch.cuda.empty_cache()
    return launches, cost


def flash_32k(peaks, stats) -> None:
    """K8 at the prefill cell's attention shape (S = 32768): held against
    its plain version and timed beside its bound and SDPA.

    q is drawn 4x wider than k, so the softmax of a row falls on a few
    keys and its output is O(1) at every position: a key tile dropped or
    read twice, or a causal edge one key off, moves a row's output by
    about its own size. With randn q the outputs at position n are
    ~sqrt(e / n), ~0.01 at the middle rows, below a fixed 3e-2. The
    check is elementwise, |err| <= 1e-3 + 1e-2 |want| (one bf16 ulp is
    at most 2^-7 of the value), and rms(err) / rms(want) <= 1e-2."""
    b, s, h, kh, hd = 2, 32768, 16, 2, 128
    g = torch.Generator("cuda").manual_seed(32)
    q, k, v = (torch.randn(shape, generator=g, device="cuda") for shape in
               ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    q, k, v = ((q * 4).to(torch.bfloat16), k.to(torch.bfloat16),
               v.to(torch.bfloat16))
    flash.reset_launch_counts()
    got = flash.flash_attention_local(q, k, v, causal=True)
    check(flash.LAUNCHES["flash_attention_wgmma"] == 1,
          f"K8 at S=32768 must launch the wgmma kernel: {flash.LAUNCHES}")
    want = flash.flash_attention_local_plain(q, k, v, causal=True).float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    worst = float((diff - 1e-2 * want.abs()).max())
    rms_want = float(want.square().mean().sqrt())
    rel_rms = float(diff.square().mean().sqrt()) / rms_want
    rel_max = err / float(want.abs().max())
    print(f"K8 at S=32768 (q drawn 4x): max|err| {err:.3e}, max|err| / "
          f"max|want| {rel_max:.3e}, rms(err) / rms(want) {rel_rms:.3e}, "
          f"rms(want) {rms_want:.3f}, worst |err| - 1e-2 |want| "
          f"{worst:.3e} (bound 1e-3)")
    check(bool(got.float().isfinite().all()) and worst <= 1e-3
          and rel_rms <= 1e-2,
          f"K8 at S=32768: |err| - 1e-2 |want| reaches {worst} (bound "
          f"1e-3), rms(err) / rms(want) {rel_rms} (bound 1e-2)")
    del want, diff
    k_ms = device_ms(lambda: flash.flash_attention_local(q, k, v),
                     reps=5, inner=3)
    p_ms = device_ms(lambda: flash.flash_attention_local_plain(q, k, v),
                     reps=3, inner=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=5, inner=3)
    b_ms, b_by = flash_bound_ms(q, k, True, peaks)
    print(f"K8 B={b} S={s} H={h} K={kh} hd={hd} causal bf16 wgmma: "
          f"max|err|={err:.3e} (tol 1e-3 + 1e-2 |want|) "
          f"kernel_ms={k_ms:.6f} "
          f"bound_ms={b_ms:.6f} ({b_by}) share {b_ms / k_ms:.1%} "
          f"sdpa_ms={lib_ms:.6f} plain_ms={p_ms:.6f}")
    stats["flash"]["s32k"] = {
        "shape": f"B={b} S={s} H={h} K={kh} hd={hd} causal",
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}


def phase_roofline(smi: str, peaks, stats) -> None:
    print("== phase 20b: four cells on one card, counted and measured; "
          "the roofline at gpu_sm90's published 989 TFLOP/s (bf16 dense) "
          f"and 3.35 TB/s; {smi} ==")
    rows: list = []
    flash_32k(peaks, stats)
    pre = ShapeCell("prefill_32k", 32768, 2, "prefill")
    meta_mesh = make_mesh((1, 1), ("data", "model"), ["meta"])
    cfg_j, knobs_j = tuning.tuned(configs.get_config("qwen2.5-3b"),
                                  "prefill_32k", meta_mesh)
    jnp_cost, _ = dryrun.count_cell(cfg_j, pre, None, knobs_j)
    launches, flash_cost = measured_cell(
        "qwen2.5-3b", "prefill_32k", pre, ["global_batch 32 -> 2"], smi,
        rows, attn_impl="flash")
    check(launches == {"flash_attention": 36, "flash_attention_wgmma": 36},
          f"the prefill cell must launch K8 once a layer: {launches}")
    stats["flash"].setdefault("paths", {})[
        "phase 20 prefill_32k (qwen2.5-3b, 2 x 32768, flash)"] = 36
    print(f"the same cell on the jnp route, counted: {jnp_cost.dot_flops:.6e}"
          f" dot FLOPs ({jnp_cost.dot_flops / flash_cost.dot_flops:.3f}x "
          f"the flash route's: the chunked route computes every key chunk, "
          f"K8 only the causal blocks), {jnp_cost.hbm_proxy_bytes:.6e} "
          f"proxy bytes")
    measured_cell("qwen2.5-3b", "decode_32k",
                  ShapeCell("decode_32k", 32768, 8, "decode"),
                  ["global_batch 128 -> 8"], smi, rows,
                  fill=lambda c: fill_kv(c, 32767, 1))
    measured_cell("qwen2.5-3b", "train_4k",
                  ShapeCell("train_4k", 4096, 1, "train"),
                  ["global_batch 256 -> 1"], smi, rows)
    measured_cell("mamba2-2.7b", "long_500k", SHAPES["long_500k"], [], smi,
                  rows)
    print(f"phase 20b cells: {json.dumps(rows)}")
    stats["roofline_cells"] = rows


# Phase 20c/20d's inputs, each drawn from its own seed so that a rank of
# phase 20d draws what phase 20c drew: K8 at qwen2.5-3b's heads, K7 on
# mamba2-2.7b's conv, the sequence-parallel SSD at the reference test's
# shapes and mamba2-2.7b's heads, the pipeline's input, the compressed
# sum's and the remesh's tensors; the pipeline's 36 layers come from one
# generator whose state is kept at each stage's first layer.
C2_SSD = (("tests/test_ssm_sp.py", (2, 256, 4, 8, 16, 32)),
          ("mamba2-2.7b heads", (1, 2048, 80, 64, 128, 256)))
C2_PIPE = {"stages": 4, "micro": 4, "mb": 2, "seq": 128}
C2_PSUM = {"wq": (2048, 2048), "wk": (2048, 256), "bq": (2048,)}
# qwen2.5-3b's attention axes for the remesh's state (layers/attention.py)
C2_REMESH_SPECS = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
                   "bq": ("heads",)}


def c2_gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def c2_flash_inputs(device):
    g = c2_gen(20, device)
    return tuple(torch.randn(shape, generator=g, device=device).to(
        torch.bfloat16) for shape in ((4, 2048, 16, 128), (4, 2048, 2, 128),
                                      (4, 2048, 2, 128)))


def c2_conv_inputs(device):
    g = c2_gen(21, device)
    x = torch.randn((4, 2048, 5376), generator=g, device=device)
    w = torch.randn((4, 5376), generator=g, device=device) * 0.5
    bias = torch.randn((5376,), generator=g, device=device)
    return tuple(t.to(torch.bfloat16) for t in (x, w, bias))


def c2_ssd_inputs(shape, device):
    bsz, length, m, p, nst, _ = shape
    g = c2_gen(22, device)
    xs = torch.randn((bsz, length, 1, m, p), generator=g, device=device)
    dt = F.softplus(torch.randn((bsz, length, 1, m), generator=g,
                                device=device))
    a = -torch.exp(torch.randn((1, m), generator=g, device=device) * 0.3)
    bm, cm = (torch.randn((bsz, length, 1, nst), generator=g,
                          device=device) * 0.3 for _ in range(2))
    return xs, dt, a, bm, cm


def c2_pipe_cfg():
    return dataclasses.replace(configs.get_config("qwen2.5-3b"),
                               dtype=torch.float32, remat="none")


def c2_pipe_input(cfg, device):
    p = C2_PIPE
    return torch.randn((p["micro"], p["mb"], p["seq"], cfg.d_model),
                       generator=c2_gen(23, device), device=device)


def c2_stage_fn(cfg, device):
    pos = torch.arange(C2_PIPE["seq"], device=device).expand(
        C2_PIPE["mb"], C2_PIPE["seq"])

    def stage_fn(stage_layers, h):
        for layer in stage_layers:
            h = layer(h, pos[:h.shape[0]], cfg)[0]
        return h
    return stage_fn


def c2_psum_inputs(device):
    g = c2_gen(24, device)
    grads = [{n: torch.randn(s, generator=g, device=device)
              for n, s in C2_PSUM.items()} for _ in range(4)]
    res = [{n: torch.randn(s, generator=g, device=device) * 1e-3
            for n, s in C2_PSUM.items()} for _ in range(4)]
    return grads, res


def c2_remesh_state(device):
    from repro_torch.train.trainstep import TrainState
    g = c2_gen(25, device)
    return TrainState({n: torch.randn(s, generator=g, device=device)
                       for n, s in C2_PSUM.items()},
                      {"step": torch.tensor(3, device=device)})


def c2_blocks(state) -> list:
    """Every leaf's blocks in this process, by shard: shard ``i``'s leaves
    in name order (the step counter last)."""
    leaves = [state.params[n] for n in sorted(state.params)]
    leaves.append(state.opt_state["step"])
    return [[leaf.shards[i] for leaf in leaves]
            for i in range(len(leaves[0].shards))]


def phase_c2(smi: str, stats, want: dict) -> None:
    """Phase 20c: the sharded LM pieces on in-process meshes of the card;
    ``want`` gets the digests (``train.checkpoint.state_digest``) of each
    piece's result by shard, which phase 20d's ranks are held to."""
    from repro_torch.core import ssm_sp
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.pipeline import pipeline_forward, split_stages
    from repro_torch.kernels import ops
    from repro_torch.layers.ssm import ssd_scan
    from repro_torch.models.lm import DecoderLayer
    from repro_torch.train.compression import EFState, compressed_psum
    from repro_torch.train.fault import remesh_state
    print("== phase 20c: the sharded LM pieces on in-process meshes of "
          f"the card; {smi} ==")
    # K8 sharded over a (2, 2) data x model mesh at qwen2.5-3b's heads
    q, k, v = c2_flash_inputs("cuda")
    whole = flash.flash_attention_local(q, k, v, causal=True)
    mesh = make_mesh((2, 2), ("data", "model"))
    reset_all_launches()
    with shd.use_mesh(mesh):
        got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    n = flash.LAUNCHES["flash_attention_wgmma"]
    check(n == 4 and torch.equal(got, whole),
          f"sharded K8 on (2, 2): {n} launches, equal "
          f"{torch.equal(got, whole)}")
    want["k8"] = state_digest(got)
    stats["flash"].setdefault("paths", {})[
        "phase 20 ops.flash_attention on a (2, 2) data x model mesh"] = n
    print(f"K8 on a (2, 2) data x model mesh, B=4 S=2048 H=16 K=2 hd=128 "
          f"bf16: 4 launches (a batch half x a KV head each), bit for bit "
          f"the unsharded call")
    # K7 on 4 sequence shards of mamba2-2.7b's conv (conv_dim 5376)
    x, w, bias = c2_conv_inputs("cuda")
    sp = make_mesh((4,), ("sp",))
    full = conv.conv1d_depthwise_causal(x, w, bias)
    reset_all_launches()
    ext = ssm_sp.conv_halo_exchange(
        shd.lay_out(x, (None, "sp"), sp).shards, 4)
    outs = [conv.conv1d_depthwise_causal(e, w, bias)[:, 3:] for e in ext]
    got = torch.cat(outs, 1)
    torch.cuda.synchronize()
    n = conv.LAUNCHES["conv1d"]
    check(n == 4 and torch.equal(got, full),
          f"K7 on 4 sequence shards: {n} launches, equal "
          f"{torch.equal(got, full)}")
    want["k7"] = [state_digest(o) for o in outs]
    stats["conv1d"].setdefault("paths", {})[
        "phase 20 conv_halo_exchange + K7, 4 sequence shards"] = n
    print("K7 after conv_halo_exchange on 4 sequence shards (B=4 L=4x512 "
          "D=5376 K=4 bf16): 4 launches, bit for bit the unsharded conv")
    # the sequence-parallel SSD: the reference test's shapes, and
    # mamba2-2.7b's heads (80 of 64, state 128, chunk 256)
    for label, shape in C2_SSD:
        xs, dt, a, bm, cm = c2_ssd_inputs(shape, "cuda")
        ch = shape[-1]
        ref, _ = ssd_scan(xs, dt, a, bm, cm, ch, torch.float32)
        parts = [shd.lay_out(t, (None, "sp"), sp).shards
                 for t in (xs, dt, bm, cm)]
        ys = ssm_sp.ssd_sequence_parallel(*parts[:2], a, *parts[2:], ch)
        want[f"ssd {label}"] = [state_digest(y) for y in ys]
        err = float((torch.cat(ys, 1) - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        print(f"ssd_sequence_parallel, 4 shards, {label}: max |err| "
              f"{err:.3e} vs the single-device SSD (max |y| "
              f"{float(ref.abs().max()):.3f}; bound 2e-4 x max(1, |y|))")
        check(err < 2e-4 * scale, f"sequence-parallel SSD off by {err}")
    # qwen2.5-3b's 36 layers in 4 pipeline stages, f32
    cfg = c2_pipe_cfg()
    gen = c2_gen(3, "cuda")
    init = ParamInit(cfg, device="cuda", generator=gen)
    per_stage = cfg.n_layers // C2_PIPE["stages"]
    layers, want["pipe_gen"] = [], []
    for i in range(cfg.n_layers):
        if i % per_stage == 0:
            want["pipe_gen"].append(gen.get_state().tolist())
        layers.append(DecoderLayer(init, cfg))
    micro, mb, seq = C2_PIPE["micro"], C2_PIPE["mb"], C2_PIPE["seq"]
    xin = c2_pipe_input(cfg, "cuda")
    stage_fn = c2_stage_fn(cfg, "cuda")
    pipe = pipeline_forward(stage_fn, make_mesh((4,), ("stage",)))
    stages = split_stages(layers, 4)
    params = [p for layer in layers for p in layer.parameters()]
    y = pipe(stages, xin)
    with torch.no_grad():
        seq_y = torch.stack([stage_fn(layers, xin[i]) for i in range(micro)])
    check(torch.equal(y.detach(), seq_y),
          "the pipelined forward != the sequential one at equal microbatch")
    posw = torch.arange(seq, device="cuda").expand(mb * micro, seq)

    def whole_fn(h):
        for layer in layers:
            h = layer(h, posw, cfg)[0]
        return h

    yw = whole_fn(xin.reshape(micro * mb, seq, -1)).reshape(y.shape)
    diff = (y - yw).detach().abs()
    top = float(yw.detach().abs().max())
    excess_f = float((diff - 2e-5 * yw.detach().abs()).max())
    # The whole batch runs each GEMM on 4x the rows, which cuBLAS sums in
    # another order; 36 random-weight layers carry that to ~1e-4 at
    # |y| ~ 1e2, so elementwise 2e-5 (the reference's 8 tanh layers of
    # 32) does not hold between two right results. The pipeline's own
    # check is the bit-for-bit one above; the whole batch is held to
    # 2e-5 of max |y|.
    print(f"pipeline, 36 layers of qwen2.5-3b in 4 stages, {micro} "
          f"microbatches of {mb} x {seq} (f32): bit for bit the sequential "
          f"forward; the whole batch at once max |diff| "
          f"{float(diff.max()):.3e} against max |y| {top:.3f} (bound "
          f"2e-5 x max |y|; elementwise, the largest excess over "
          f"2e-5*|y| + 2e-5 is {excess_f - 2e-5:.3e}, not gated)")
    check(float(diff.max()) <= 2e-5 * top,
          f"pipeline vs the whole batch: max |diff| {float(diff.max())}")
    scale = float(yw.detach().pow(2).mean())
    gp = torch.autograd.grad((y ** 2).mean() / scale, params)
    gs = torch.autograd.grad((yw ** 2).mean() / scale, params)
    worst = max(float(((a - b).abs() - 5e-4 * b.abs()).max())
                for a, b in zip(gp, gs))
    print(f"pipeline gradients of {len(params)} tensors vs the whole "
          f"batch's: largest excess over 5e-4*|g| {worst:.3e} (atol 5e-5)")
    check(worst <= 5e-5, f"pipeline gradients off: {worst}")
    per_p = len(params) // C2_PIPE["stages"]
    want.update(pipe_y=state_digest(y.detach()), pipe_scale=scale,
                pipe_g=[state_digest(list(gp[s * per_p:(s + 1) * per_p]))
                        for s in range(C2_PIPE["stages"])])
    del layers, params, gp, gs, y, yw, stages
    gc.collect()
    torch.cuda.empty_cache()
    # the compressed all-reduce over 4 replicas, card against CPU
    grads, res = c2_psum_inputs("cuda")
    res = [EFState(r) for r in res]
    for mode in ("int8", "bf16"):
        m_c, e_c = compressed_psum(grads, res, mode)
        m_h, e_h = compressed_psum(
            [{n: t.cpu() for n, t in gr.items()} for gr in grads],
            [EFState({n: t.cpu() for n, t in e.residual.items()})
             for e in res], mode)
        same = all(torch.equal(m_c[r][n].cpu(), m_h[r][n])
                   and torch.equal(e_c[r].residual[n].cpu(),
                                   e_h[r].residual[n])
                   for r in range(4) for n in C2_PSUM)
        check(same, f"compressed_psum ({mode}) on the card != on the CPU")
        want[f"psum {mode}"] = [state_digest([m_c[r], e_c[r].residual])
                                for r in range(4)]
        print(f"compressed_psum over 4 replicas ({mode}): means and "
              f"residuals on the card bit for bit the CPU port's")
    # remesh_state from (2, 2) onto (2,): the blocks each shard holds
    state = c2_remesh_state("cuda")
    cur = remesh_state(state, mesh, C2_REMESH_SPECS)
    new = remesh_state(cur, make_mesh((2,), ("data",)), C2_REMESH_SPECS)
    check(all(torch.equal(new.params[n].full(), state.params[n])
              for n in C2_PSUM), "remesh_state (2, 2) -> (2,) lost data")
    want["remesh"] = {"(2, 2)": [state_digest(b) for b in c2_blocks(cur)],
                      "(2,)": [state_digest(b) for b in c2_blocks(new)]}
    print("remesh_state of wq, wk, bq and the step from (2, 2) onto (2,): "
          "gathered, the original bit for bit")


def rank_c2(rank: int, out_dir: str, want: dict) -> None:
    """One rank of phase 20d (started by ``dist.process.spawn``): each
    sharded LM piece of phase 20c one rank a shard over the process
    group, on this rank's card, on the inputs phase 20c drew (the same
    seeds; this rank's pipeline stage from the generator state phase 20c
    kept), its result's digest held to phase 20c's for this rank's
    shard; the K8 and K7 launches counted; one JSON file a rank."""
    from repro_torch.core import ssm_sp
    from repro_torch.dist import ProcessMesh
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.pipeline import pipeline_forward
    from repro_torch.kernels import ops
    from repro_torch.models.lm import DecoderLayer
    from repro_torch.train.compression import EFState, compressed_psum
    from repro_torch.train.fault import remesh_state
    # As phase 20c's process computes: TF32 off, and cuBLAS at its default
    # workspace (phase 19 sets the variable after this process's parent
    # made its cuBLAS handles; a workspace of another size may pick other
    # GEMM algorithms, which sum in another order).
    os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict = {}

    def same(key, got, digest):
        out[key] = {"equal": state_digest(got) == digest}
        return out[key]

    square = ProcessMesh((2, 2), ("data", "model"))
    dev = square.device_here
    q, k, v = c2_flash_inputs(dev)
    reset_all_launches()
    with shd.use_mesh(square):
        got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize(dev)
    same("k8", got, want["k8"])["launches"] = flash.LAUNCHES[
        "flash_attention_wgmma"]
    sp = ProcessMesh((4,), ("sp",))
    x, w, bias = c2_conv_inputs(dev)
    mine = shd.lay_out(x, (None, "sp"), sp).shards[0]
    reset_all_launches()
    ext = ssm_sp.conv_halo_exchange(mine, 4, mesh=sp, axis="sp")
    got = conv.conv1d_depthwise_causal(ext, w, bias)[:, 3:]
    torch.cuda.synchronize(dev)
    same("k7", got, want["k7"][rank])["launches"] = conv.LAUNCHES["conv1d"]
    for label, shape in C2_SSD:
        xs, dt, a, bm, cm = c2_ssd_inputs(shape, dev)
        parts = [shd.lay_out(t, (None, "sp"), sp).shards[0]
                 for t in (xs, dt, bm, cm)]
        same(f"ssd {label}", ssm_sp.ssd_sequence_parallel(
            parts[0], parts[1], a, parts[2], parts[3], shape[-1], mesh=sp,
            axis="sp"), want[f"ssd {label}"][rank])
    # this rank's stage of qwen2.5-3b: its 9 layers drawn from the state
    # phase 20c's generator had at the stage's first layer
    cfg = c2_pipe_cfg()
    stage = ProcessMesh((4,), ("stage",))
    gen = c2_gen(3, dev)
    gen.set_state(torch.tensor(want["pipe_gen"][rank], dtype=torch.uint8))
    init = ParamInit(cfg, device=dev, generator=gen)
    layers = [DecoderLayer(init, cfg)
              for _ in range(cfg.n_layers // C2_PIPE["stages"])]
    params = [p for layer in layers for p in layer.parameters()]
    pipe = pipeline_forward(c2_stage_fn(cfg, dev), stage)
    xin = c2_pipe_input(cfg, dev)
    steps = C2_PIPE["micro"] + C2_PIPE["stages"] - 1

    def forward_backward():
        torch.distributed.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y = pipe(layers, xin)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        grads = torch.autograd.grad((y ** 2).mean() / want["pipe_scale"],
                                    params)
        torch.cuda.synchronize(dev)
        return y.detach(), list(grads), (t1 - t0, time.perf_counter() - t1)

    # The first call pays for the ranks' first messages each way and the
    # card's first kernels; the second is timed.
    _, _, first = forward_backward()
    y, grads, (fwd, bwd) = forward_backward()
    same("pipe y", y, want["pipe_y"])
    same("pipe grads", grads, want["pipe_g"][rank])
    out["pipe us a step"] = {"forward": fwd / steps * 1e6,
                             "backward": bwd / steps * 1e6,
                             "first call s": sum(first)}
    del layers, params, grads, y
    dp = ProcessMesh((4,), ("dp",))
    grads, res = c2_psum_inputs(dev)
    for mode in ("int8", "bf16"):
        mean, ef = compressed_psum(grads[rank], EFState(res[rank]), mode,
                                   mesh=dp, axis="dp")
        same(f"psum {mode}", [mean, ef.residual], want[f"psum {mode}"][rank])
    cur = remesh_state(c2_remesh_state(dev), square, C2_REMESH_SPECS)
    small = ProcessMesh((2,), ("data",), ranks=[0, 1])
    new = remesh_state(cur, small, C2_REMESH_SPECS)
    same("remesh (2, 2)", c2_blocks(cur)[0], want["remesh"]["(2, 2)"][rank])
    held = c2_blocks(new)
    out["remesh (2,)"] = {"equal": (
        state_digest(held[0]) == want["remesh"]["(2,)"][rank]
        if rank < 2 else held == [])}
    out["devices"] = [str(d) for d in square.devices]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def check_c2_ranks(label: str, backend: str, want: dict, smi: str,
                   stats) -> None:
    """Spawn four ranks over ``backend`` running :func:`rank_c2`; check
    and print what each saved."""
    import tempfile
    from repro_torch.dist import process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        process.spawn(rank_c2, 4, tmp, want, backend=backend, timeout_s=300)
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{k}.json").read_text())
                 for k in range(4)]
    wall = time.perf_counter() - t0
    pieces = [key for key, v in ranks[0].items()
              if isinstance(v, dict) and "equal" in v]
    for key in pieces:
        per = [r[key] for r in ranks]
        check(all(p["equal"] for p in per),
              f"{label} {key}: ranks bit for bit phase 20c's shards "
              f"{[p['equal'] for p in per]}")
    for key, kernel in (("k8", "K8"), ("k7", "K7")):
        n = [r[key]["launches"] for r in ranks]
        check(n == [1] * 4, f"{label} {kernel}: launches {n} a rank, want 1")
    stats["flash"]["paths"][
        f"phase 20d ops.flash_attention on a (2, 2) ProcessMesh, 4 "
        f"{backend} ranks"] = 4
    stats["conv1d"]["paths"][
        f"phase 20d conv_halo_exchange (ppermute) + K7, (4,) ProcessMesh, "
        f"4 {backend} ranks"] = 4
    steps = [r["pipe us a step"] for r in ranks]
    print(f"[{label}] four ranks over {backend} on {ranks[0]['devices']}: "
          f"every rank's {', '.join(pieces)} bit for bit phase 20c's for "
          f"its shard (digests); K8 1 launch a rank (4 in all), K7 1 a rank "
          f"(4 in all); ranks 2-3 hold no block after the remesh onto (2,)")
    print(f"[{label}] pipeline host us a step a rank, forward "
          f"{[round(s['forward'], 1) for s in steps]}, backward "
          f"{[round(s['backward'], 1) for s in steps]} "
          f"({C2_PIPE['micro'] + C2_PIPE['stages'] - 1} steps, the second "
          f"call; the first call's forward and backward "
          f"{[round(s['first call s'], 3) for s in steps]} s); spawn and "
          f"all pieces {wall:.1f}s; on {smi}")


def phase_c2_ranks(smi: str, stats, want: dict) -> None:
    """Phase 20d: the sharded LM pieces one rank a shard."""
    print("== phase 20d: the sharded LM pieces one rank a shard, four gloo "
          "ranks sharing the card ==")
    check_c2_ranks("20d gloo", "gloo", want, smi, stats)
    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"== phase 20d NCCL: needs 4 cards (one NCCL rank a card for "
              f"the 4-shard meshes; NCCL refuses ranks that share a card); "
              f"{cards} present: not run ==")
        return
    check_c2_ranks("20d nccl", "nccl", want, smi, stats)


# Phase 20e: the partitioned LM program on four gloo ranks sharing the
# card, as phase 20d spawns them.
PARTITION = dict(arch="qwen2.5-3b", layers=4, batch=2, seq=2048,
                 rtol=2e-5)


def probe_gloo(rank: int, out_dir: str, op: str) -> None:
    """One rank of phase 20e's probe: the collective ``op`` (a
    ``_c10d_functional`` name the program's fake count holds) once on
    CUDA tensors over gloo in the functional form DTensor issues; its
    refusal's text, or None, to ``<out_dir>/probe<rank>.json``."""
    from torch.distributed import _functional_collectives as funcol
    torch.cuda.set_device(0)
    x = torch.arange(8.0, device="cuda")
    group = list(range(4))
    calls = {
        "all_gather_into_tensor": lambda: funcol.all_gather_tensor(
            x, 0, group),
        "all_reduce": lambda: funcol.all_reduce(x, "sum", group),
        "reduce_scatter_tensor": lambda: funcol.reduce_scatter_tensor(
            x, "sum", 0, group),
        "all_to_all_single": lambda: funcol.all_to_all_single(
            x, None, None, group),
    }
    calls["shard_dim_alltoall"] = calls["all_to_all_single"]
    try:
        float(calls[op]().sum())
        out = None
    except RuntimeError as e:
        out = f"{type(e).__name__}: {e}"[:400]
    with open(os.path.join(out_dir, f"probe{rank}.json"), "w") as f:
        json.dump(out, f)


def refusals(ops: list) -> dict:
    """Each of ``ops`` probed on four gloo ranks of the card, in a spawn
    of its own: ``{op: why}`` for each op gloo refuses, a raised error's
    text or the signal that ended the ranks (the functional form's wait
    on CUDA tensors can end a gloo rank with SIGSEGV, which no exception
    reports)."""
    import tempfile
    from torch.multiprocessing import ProcessExitedException
    from repro_torch.dist import process
    out = {}
    for op in ops:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                process.spawn(probe_gloo, 4, tmp, op, backend="gloo",
                              timeout_s=60)
            except ProcessExitedException as e:
                out[op] = f"a rank ended: {e}"
                continue
            why = [json.loads((pathlib.Path(tmp) / f"probe{r}.json")
                              .read_text()) for r in range(4)]
        if any(why):
            out[op] = next(w for w in why if w)
    return out


def phase_partition(smi: str, stats) -> None:
    """Phase 20e: the partitioned program over four gloo ranks."""
    import tempfile
    from repro_torch.dist import process
    from repro_torch.launch import partition
    from repro_torch.launch.mesh import fake_device_mesh
    p = PARTITION
    prog = partition.Program(
        partition.config(p["arch"], layers=p["layers"], full=True,
                         attn_impl="flash"),
        "prefill", p["batch"], p["seq"])
    print(f"== phase 20e: the partitioned LM program on four gloo ranks "
          f"sharing the card: {p['arch']} at full width, {p['layers']} "
          f"layers, f32, prefill of {p['batch']} x {p['seq']} tokens, "
          f"attn_impl=flash, on a (2, 2) data x model DeviceMesh ==")
    t0 = time.perf_counter()
    fake = partition.fake_collectives(prog, "cuda")
    print(f"[20e] the fake-group count on meta: {fake['counts']}, bytes "
          f"{fake['bytes']}")
    refused = refusals(sorted(fake["counts"]))
    if not refused:
        with tempfile.TemporaryDirectory() as tmp:
            process.spawn(partition.rank_main, 4, tmp, [prog], "cuda",
                          backend="gloo", timeout_s=600)
            lines = partition.check([prog], tmp, 4, "cuda", "cuda",
                                    p["rtol"])
            launches = [json.loads((pathlib.Path(tmp) / f"0.{r}.json")
                                   .read_text())["launches"]
                        for r in range(4)]
        for line in lines:
            print(f"[20e gloo] {line}")
        where = "4 gloo ranks"
    else:
        for op, why in sorted(refused.items()):
            print(f"[20e gloo] gloo refuses {op} on CUDA tensors: {why}")
        print("[20e] the real check waits for NCCL on 4 cards (one rank a "
              "card); the program runs over a fake group on CUDA tensors "
              "in this process instead, its output not checked")
        with fake_device_mesh(*partition.MESH, "cuda") as mesh:
            flash.reset_launch_counts()
            partition.run(prog, "cuda", mesh)
            launches = [flash.LAUNCHES["flash_attention"]]
            got = partition.collectives(prog, "cuda", mesh)
        for key in ("counts", "bytes", "count"):
            check(got[key] == fake[key], f"20e fake group on CUDA: {key} "
                  f"{got[key]} != the meta count's {fake[key]}")
        print(f"[20e fake] collectives {got['counts']} = the meta count's, "
              f"bytes {got['bytes']} = the meta count's")
        where = "a fake group on CUDA tensors"
    check(launches == [p["layers"]] * len(launches),
          f"20e: K8 launches {launches} a rank, want {p['layers']}")
    stats["flash"]["paths"][
        f"phase 20e partitioned prefill (local_map), {where}"] = \
        sum(launches)
    print(f"[20e] K8 through local_map: {launches} launches a rank; "
          f"probes and program {time.perf_counter() - t0:.1f}s; on {smi}")


def main() -> None:
    smi, peaks = card()
    print(f"== phase 1: card: {smi} ==")
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    print(f"== phase 2: built {sorted(libs)} in "
          f"{time.perf_counter() - t0:.1f}s ==")
    dry = start_dryrun()
    try:
        phases(smi, peaks, dry)
    finally:  # a failed phase leaves no worker running
        for proc, _ in dry[1]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phases(smi: str, peaks, dry) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stats: dict = {}
    seconds = {}

    def run(name, fn, *args, free=False):
        t0 = time.perf_counter()
        fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"-- {name}: {seconds[name]} s --")
        if free:  # this phase's model, so the next phase's peak is its own
            gc.collect()
            torch.cuda.empty_cache()

    run("phase 3 kernels", phase_kernels, peaks, stats)
    run("phase 3 subnormals", phase_subnormals)
    run("phase 4 main path", phase_main, smi, stats)
    run("phase 5 paths", phase_paths, stats)
    run("phase 6 flash", phase_flash, peaks, stats)
    run("phase 7 qwen2.5 serving", phase_serve, smi, stats, free=True)
    run("phase 8 conv", phase_conv, peaks, stats)
    run("phase 9 mamba2 serving", phase_ssm, smi, stats, free=True)
    run("phase 10 stream", phase_stream, peaks, stats, smi, free=True)
    run("phase 11 zamba2 serving", phase_hybrid, smi, stats, free=True)
    run("phase 12 solve serving", phase_solve_serve, smi, stats)
    run("phase 13 distributed", phase_dist, smi, stats)
    run("phase 13b-c ranks and cards", phase_dist_cards, smi, stats)
    run("phase 14 grayskull", phase_grayskull, smi, stats)
    run("phase 15 jacobi", phase_jacobi, smi, stats)
    run("phase 16 decoders", phase_decoders, smi, stats, free=True)
    run("phase 17 moe serving", phase_moe, smi, stats, free=True)
    run("phase 18 encoder", phase_encoder, smi, stats, free=True)
    run("phase 19 training", phase_train, smi, stats, free=True)
    run("phase 20a dry run", phase_dryrun, dry, smi)
    run("phase 20b roofline cells", phase_roofline, smi, peaks, stats,
        free=True)
    c2: dict = {}
    run("phase 20c sharded", phase_c2, smi, stats, c2, free=True)
    run("phase 20d sharded ranks", phase_c2_ranks, smi, stats, c2)
    run("phase 20e partitioned ranks", phase_partition, smi, stats)
    print(f"phase seconds: {json.dumps(seconds)}")
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
                                 "run_distributed_ranks", "grayskull_sim")
               if k in s}})
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
            **({"paths": {s["path"]: s["launches"], **s["paths"]}}
               if dname == "bfloat16" else {}),
            # zamba2-7b's serving shape (its launches from phase 11),
            # hubert-xlarge's heads at the serving wave's shape (no path
            # runs that shape), chatglm3-6b's group of 16 (phase 16),
            # qwen3-moe-30b-a3b's group of 8 (phase 17) and hubert-xlarge's
            # at phase 18's shape (its flash forward)
            **{key: {"launches": 0, **s[key][dname]}
               for key in ("hd112", "hd80", "group16", "group8",
                           "hubert")},
            # phase 20's prefill cell's attention (S = 32768), bf16
            **({"s32k": {"launches": 36, **s["s32k"]}}
               if dname == "bfloat16" else {})})
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
