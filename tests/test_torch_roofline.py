"""The port's cost counter (``repro_torch.hlo_analysis``, read from the
aten-op stream) and roofline against the JAX package's ``analyze_hlo``
and ``roofline`` on the CPU.

* The reference test's 6-layer relu MLP (``tests/test_hlo_analysis.py``)
  on one device: the port's dot FLOPs equal the analytic
  6 * 2 * 2 * 8 * 256 * 512 exactly, and the JAX ``analyze_hlo`` count
  of the unrolled program.
* One smoke cell of each family (dense qwen2.5, moe qwen3-moe, mla
  minicpm3, vlm internvl2, ssm mamba2, hybrid zamba2, encoder hubert;
  train, prefill and decode where supported), the JAX program compiled
  on one CPU device by the reference dry run's route (``attn_impl="jnp"``,
  the tuned remat and parameter dtype, AdamW with ``warmup_cosine`` and
  two microbatches for train), the port's program counted on ``meta``:
  the dot FLOPs agree within ``RTOL`` = 0.1%, except one difference,
  which is exact and explained: the MoE train cell counts one more
  combine product (``gtec,gecd->gtd``, ``2 g t e c d`` FLOPs) a layer
  and a microbatch (+3.2% at smoke size). Under ``remat="full"`` the
  port's ``torch.utils.checkpoint`` replays the layer's forward in order
  up to the last tensor its backward needs, the router z-loss's
  ``logsumexp``, which the MoE layer computes after the combine, so the
  combine product runs again though nothing reads its output; XLA
  dead-code-eliminates that recomputed product. It is work the card
  does. The mamba2 and zamba2 train cells read -0.07% and -0.06%,
  within the bound.
* The same cells' HBM proxy bytes, against ``analyze_hlo``'s: the two
  proxies count different things, so each cell's ratio (port over
  reference) is pinned in ``PROXY_RATIO``. The reference's walk counts
  each XLA fusion's result; the port counts no elementwise op but every
  dtype cast (``_to_copy``) and ``clone``. Where they part:

  - decode, 0.09-0.17: the CPU backend runs bf16 dots in f32, so the
    reference's compile writes an f32 copy of every bf16 weight and of
    the KV cache it reads (``convert`` fusions: 1.48e6 of qwen2.5-3b's
    2.94e6 bytes); one token a sequence does little else, and the
    port's bf16 matmuls read the bf16 weights as they are;
  - train and prefill, 0.46-0.72: the reference's elementwise loop
    fusions (select, exp, multiply, add; 7.9e6 of qwen2.5-3b prefill's
    1.16e7 bytes, dots the rest) outweigh the port's casts and clones
    (3.5e6 and 1.1e6 of its 7.6e6);
  - mamba2 and zamba2 prefill, 1.09 and 0.99: the chunked SSD's f32
    casts (``_to_copy``, 1.09e7 of mamba2's 1.58e7) outweigh them.

  So the roofline's memory term (``roofline.analyze``) rests on a proxy
  that is not the reference's count, and neither is traffic.
* The counter raises on a kernel launch it has no formula for, counts
  K8 and K7 by their formulas and not their plain ops, and tracks the
  peak of live storages.
* ``resolve_hw``/``V5E`` as in ``tests/test_device.py``; ``analyze``'s
  terms, partitioned (the collective term) and not (``None``), and
  ``memory_per_device``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro import roofline as JR
from repro.engine.device import get_device as j_get_device
from repro.hlo_analysis import analyze_hlo
from repro.models.registry import build_model as jax_build
from repro.train.optimizer import adamw as j_adamw
from repro.train.optimizer import warmup_cosine as j_wc
from repro.train.trainstep import TrainState as JState
from repro.train.trainstep import make_train_step as j_step
from repro_torch import configs as TC
from repro_torch import hlo_analysis as H
from repro_torch import roofline as TR
from repro_torch.engine.device import get_device
from repro_torch.kernels import build
from repro_torch.kernels.conv1d import conv1d_depthwise_causal
from repro_torch.kernels.flash_attention import flash_attention_local
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer as TO
from repro_torch.train import trainstep as TT

RTOL = 1e-3
B, S, ACC = 4, 64, 2
#: Port's HBM proxy bytes over the reference's, each smoke cell (see the
#: module note).
PROXY_RATIO = {
    ("qwen2.5-3b", "train"): 0.482, ("qwen2.5-3b", "prefill"): 0.661,
    ("qwen2.5-3b", "decode"): 0.155,
    ("qwen3-moe-30b-a3b", "train"): 0.515,
    ("qwen3-moe-30b-a3b", "prefill"): 0.693,
    ("qwen3-moe-30b-a3b", "decode"): 0.093,
    ("minicpm3-4b", "train"): 0.469, ("minicpm3-4b", "prefill"): 0.622,
    ("minicpm3-4b", "decode"): 0.119,
    ("internvl2-2b", "train"): 0.484, ("internvl2-2b", "prefill"): 0.670,
    ("internvl2-2b", "decode"): 0.165,
    ("mamba2-2.7b", "train"): 0.686, ("mamba2-2.7b", "prefill"): 1.085,
    ("mamba2-2.7b", "decode"): 0.170,
    ("zamba2-7b", "train"): 0.634, ("zamba2-7b", "prefill"): 0.992,
    ("zamba2-7b", "decode"): 0.151,
    ("hubert-xlarge", "train"): 0.459, ("hubert-xlarge", "prefill"): 0.658,
}
CELLS = [(arch, kind)
         for arch in ("qwen2.5-3b", "qwen3-moe-30b-a3b", "minicpm3-4b",
                      "internvl2-2b", "mamba2-2.7b", "zamba2-7b",
                      "hubert-xlarge")
         for kind in ("train", "prefill", "decode")
         if not (arch == "hubert-xlarge" and kind == "decode")]


def test_mlp_counts_the_analytic_flops_and_the_jax_count():
    w = torch.randn(6, 256, 512)
    w2 = torch.randn(6, 512, 256)
    x = torch.randn(8, 256)

    def f(w, w2, x):
        c = x
        for i in range(6):
            c = torch.relu(c @ w[i]) @ w2[i]
        return c.sum()

    _, cost = H.count(f, w, w2, x)
    analytic = 6 * 2 * 2 * 8 * 256 * 512
    assert cost.dot_flops == analytic
    assert cost.collective_bytes == 0 and cost.kernels == {}

    def f_unroll(w, w2, x):
        c = x
        for i in range(6):
            c = jax.nn.relu(c @ w[i]) @ w2[i]
        return c.sum()

    comp = jax.jit(f_unroll).lower(
        jax.ShapeDtypeStruct((6, 256, 512), jnp.float32),
        jax.ShapeDtypeStruct((6, 512, 256), jnp.float32),
        jax.ShapeDtypeStruct((8, 256), jnp.float32)).compile()
    assert analyze_hlo(comp.as_text(), 1).dot_flops == cost.dot_flops


def _batch(cfg, kind, zeros, int_dtype, bf16):
    batch = {}
    if cfg.family == "encoder":
        batch["features"] = zeros((B, S, cfg.audio_feat_dim), bf16)
    else:
        s = S - (cfg.vlm_image_tokens if cfg.family == "vlm" else 0)
        batch["tokens"] = zeros((B, 1 if kind == "decode" else s),
                                int_dtype)
        if cfg.family == "vlm" and kind != "decode":
            batch["image_embeds"] = zeros(
                (B, cfg.vlm_image_tokens, cfg.vlm_vision_dim), bf16)
    if kind == "train":
        n = batch["tokens"].shape[1] if "tokens" in batch else S
        batch["labels"] = zeros((B, n), int_dtype)
    return batch


def _tuned(cfg, kind, bf16):
    return dataclasses.replace(
        cfg, remat="full" if kind == "train" else "none",
        **({} if kind == "train" else {"param_dtype": bf16}))


def _jax_cost(arch, kind):
    cfg = _tuned(JC.get_smoke_config(arch), kind, jnp.bfloat16)
    model = jax_build(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    batch = _batch(cfg, kind, jnp.zeros, jnp.int32, jnp.bfloat16)
    if kind == "train":
        opt = j_adamw(j_wc(3e-4, 2000, 100_000))
        lowered = jax.jit(j_step(model, opt, ACC)).lower(
            JState(params, opt.init(params)), batch)
    elif kind == "prefill":
        lowered = jax.jit(lambda p, b: model.forward(
            p, b, last_only=True)[0]).lower(params, batch)
    else:
        cache = model.init_cache(B, S)
        lowered = jax.jit(lambda p, c, b: model.forward(p, b, c)[:2]).lower(
            params, cache, batch)
    return analyze_hlo(lowered.compile().as_text(), 1)


def _port_cost(arch, kind):
    cfg = _tuned(TC.get_smoke_config(arch), kind, torch.bfloat16)
    model = build_model(cfg, device="meta")

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="meta")

    batch = _batch(cfg, kind, zeros, torch.int64, torch.bfloat16)
    if kind == "train":
        opt = TO.adamw(TO.warmup_cosine(3e-4, 2000, 100_000))
        step = TT.make_train_step(model, opt, ACC)
        return cfg, H.count(step, TT.init_state(model, opt), batch)[1]
    with torch.no_grad():
        if kind == "prefill":
            return cfg, H.count(lambda: model.forward(
                batch, last_only=True))[1]
        cache = model.init_cache(B, S)
        return cfg, H.count(lambda: model.forward(batch, cache))[1]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_smoke_cell_dot_flops_agree_with_jax(arch, kind):
    cfg, cost = _port_cost(arch, kind)
    ref = _jax_cost(arch, kind)
    want = ref.dot_flops
    assert cost.collective_bytes == 0 and cost.ops > 0
    assert cost.hbm_proxy_bytes / ref.hbm_proxy_bytes == pytest.approx(
        PROXY_RATIO[arch, kind], abs=2e-3), (cost.hbm_proxy_bytes,
                                             ref.hbm_proxy_bytes)
    if cfg.n_experts and kind == "train":
        tokens = B * S // ACC
        gs = min(cfg.moe_group_size, tokens)
        cap = max(1, int(gs * cfg.experts_per_token / cfg.n_experts
                         * cfg.moe_capacity_factor))
        combine = 2 * (tokens // gs) * gs * cfg.n_experts * cap * cfg.d_model
        assert cost.dot_flops - want == cfg.n_layers * ACC * combine
        return
    assert abs(cost.dot_flops - want) <= RTOL * want, (cost.dot_flops, want)


def test_uncounted_kernel_raises():
    """A launch under the counter that no formula covers raises at the
    launch (``build.load``), before any library is built or loaded."""
    with pytest.raises(H.UncountedKernelError, match="stencil"):
        with H.CostCounter():
            build.load("stencil")
    with pytest.raises(H.UncountedKernelError, match="stream"):
        H.count(build.load, "stream")
    assert build.observer() is None


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_counted_by_formula(causal, dtype):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 300, 8, 64, generator=g).to(dtype)
    k = torch.randn(2, 300, 2, 64, generator=g).to(dtype)
    with H.CostCounter() as ctr:
        out = flash_attention_local(q, k, k, causal=causal, bq=300, bk=300)
    c = ctr.cost
    assert c.kernels == {"flash_attention": 1} and c.ops == 0
    flops, nbytes = H.flash_cost(q, k, causal)
    assert c.dot_flops == flops and c.hbm_proxy_bytes == nbytes
    assert nbytes == 2 * (q.numel() + k.numel()) * q.element_size()
    # the blocks the kernel visits, counted one by one
    tq, bn = 128 // 4, (128 if dtype == torch.bfloat16 else 32)
    pairs = 0
    for q0 in range(0, 300, tq):
        for row in range(q0, min(q0 + tq, 300)):
            k_end = min(300, q0 + tq) if causal else 300
            pairs += 4 * min(-(-k_end // bn) * bn, 300)
    assert flops == 4 * 64 * pairs * 2 * 2
    assert torch.equal(out, flash_attention_local(q, k, k, causal=causal,
                                                  bq=300, bk=300))
    assert c.peak_bytes == out.untyped_storage().nbytes()
    x = torch.randn(2, 64, 16)
    w = torch.randn(4, 16)
    with H.CostCounter() as ctr:
        conv1d_depthwise_causal(x, w, None)
    assert ctr.cost.kernels == {"conv1d": 1} and ctr.cost.dot_flops == 0
    assert ctr.cost.hbm_proxy_bytes == (2 * x.numel() + w.numel()) * 4


def test_peak_bytes_tracks_live_storages():
    def prog():
        a = torch.empty(1000, device="meta")          # 4000 live
        b = a + 1                                      # 8000
        del a                                          # 4000
        c = torch.cat([b, b])                          # 12000
        v = c[:10]                                     # a view: no bytes
        return v

    with H.CostCounter() as ctr:
        v = prog()
    assert ctr.cost.peak_bytes == 12000
    assert ctr.tracked(v)
    assert ctr.cost.hbm_proxy_bytes == 2 * 8000  # cat only: a reduce-free prog


def test_roofline_hw_comes_from_registry():
    assert TR.V5E == get_device("tpu_v5e").as_roofline_hw()
    assert TR.resolve_hw("grayskull_e150")["hbm_bw"] == \
        pytest.approx(118.4e9)
    assert TR.resolve_hw(None) is TR.V5E
    raw = {"peak_flops": 1.0}
    assert TR.resolve_hw(raw) is raw
    for name in ("tpu_v5e", "grayskull_e150", "gpu_sm90", "cpu_ref"):
        got = get_device(name).as_roofline_hw()
        assert {k: v for k, v in got.items() if k != "hbm_bytes"} == \
            j_get_device(name).as_roofline_hw()
    assert TR.resolve_hw("gpu_sm90")["hbm_bytes"] == 80 * 2**30
    assert TR.V5E["hbm_bytes"] == 16 * 2**30


def test_analyze_and_memory_per_device():
    """A partitioned count is per device as counted, its collective term
    the reference's (ICI, and the cross-pod bytes at DCI with a
    ``pod_size``); an unpartitioned one is the count over the devices
    with no collective term, and its reason."""
    hw = TR.resolve_hw("gpu_sm90")
    cost = H.LoopAwareCost(dot_flops=989e12, hbm_proxy_bytes=3.35e12 / 4,
                           collective_bytes=3 * hw["ici_bw"])
    rl = TR.analyze(cost, 4, model_flops=989e12 * 2, hw="gpu_sm90")
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(0.25)
    assert rl.coll_bytes == int(cost.collective_bytes)
    assert rl.cross_pod_bytes == 0
    assert rl.collective_s == pytest.approx(3.0)
    assert rl.collective_reason is None
    assert rl.dominant == "collective" and rl.bound_s == rl.collective_s
    assert rl.as_dict()["flops"] == 4 * cost.dot_flops
    assert rl.useful_ratio == pytest.approx(0.5)
    cost.cross_pod_bytes = hw["ici_bw"]  # a third of it across pods
    pods = TR.analyze(cost, 4, pod_size=2, hw="gpu_sm90")
    assert pods.collective_s == pytest.approx(
        2.0 + hw["ici_bw"] / hw["dci_bw"])
    one = TR.analyze(H.LoopAwareCost(dot_flops=989e12 * 4,
                                     hbm_proxy_bytes=3.35e12), 4,
                     model_flops=989e12 * 2, hw="gpu_sm90",
                     partitioned=False)
    assert one.compute_s == pytest.approx(1.0)
    assert one.memory_s == pytest.approx(0.25)
    assert one.collective_s is None and one.coll_bytes is None
    assert one.collective_reason == TR.NO_COLLECTIVES
    assert one.dominant == "compute" and one.bound_s == one.compute_s
    assert one.useful_ratio == pytest.approx(0.5)
    assert one.as_dict()["flops"] == 989e12 * 4
    assert TR.model_flops_train(10, 7) == JR.model_flops_train(10, 7)
    assert TR.model_flops_infer(10, 7) == JR.model_flops_infer(10, 7)
    mem = TR.memory_per_device(100, 40, 30, 80)
    assert mem == {"argument_size_in_bytes": 100,
                   "output_size_in_bytes": 40, "temp_size_in_bytes": 80,
                   "alias_size_in_bytes": 30, "total_nonalias": 190}
