"""The partitioned LM program (the port's DTensors on a ``DeviceMesh``, the
reference's ``jit`` with shardings) against the JAX package's
partitioned compile on the CPU, and run for real over four gloo ranks.

The JAX side is one subprocess a test run with 8 forced host devices
(``tests/_torch_partition_jax.py``), read with the reference's
``analyze_hlo``; the port's side is counted on ``meta`` over a fake
group of the same ``(2, 4)`` mesh (``launch.mesh.fake_device_mesh``),
its mesh of device type ``cpu``.

(a) The reference test's 6-layer relu MLP (``tests/test_hlo_analysis.
    py``: w ``P(None, "data", "model")``, w2 ``P(None, "model",
    "data")``, x ``P(None, "data")``), unrolled. The per-device dot
    FLOPs are equal. The collectives differ by an exact amount, derived
    in the test: each layer's first product contracts the data-split
    dim (a partial sum over data, summed before the relu) and its second
    the model-split dim (a partial sum over model, summed before the
    next layer). XLA all-reduces both, six times each, and then the last
    layer's output over model and the scalar over data; DTensor sums the
    data partials by a reduce-scatter and an all-gather (the ring
    all-reduce's two halves: the same bytes), and leaves the result a
    partial sum, as nothing asks for it whole: one model all-reduce of
    the activations and the scalar's fewer.
(b) Smoke cells of every family (train, prefill, decode), lowered as
    the reference's dry run lowers a cell (B 4, S 64, two microbatches
    for train, its tuning). The per-device dot FLOPs are equal within
    1e-3, or differ by an exact amount (``_explained``):

    - the MoE train cell counts one more combine product a layer and
      microbatch (the checkpoint replays it, ``tests/test_torch_
      roofline.py``), on each rank's block: ``2 g t e c d`` with ``g``
      over data and ``e`` over model; the MoE prefill one fewer router
      FLOPs: XLA's prefill runs the router whole on each model rank,
      the port splits its experts over model (``layers/moe.py``), as
      XLA's train step does;
    - internvl2's and hubert's train cells: XLA computes the input
      projection's weight gradient (the vision or feature projection,
      its output dim split over data by FSDP) on the rank's block only,
      the port whole, then reduce-scattered: half the product more;
    - mamba2's and zamba2's prefill: XLA splits the SSD's intra-chunk
      ``C B^T`` product (shared by a group's heads) in two, the port runs
      it whole on each model rank: half of it more a layer; their train
      step: that, in the forward, the replay and both gradient products,
      less the skip weight ``D``'s gradient, which XLA runs as a dot
      (``2 b l m p`` a layer and microbatch) and the port as a product
      and a sum;
    - three cells differ by a pinned amount not traced yet
      (``UNTRACED``: MoE decode, one group of 4 tokens with capacity 1;
      minicpm3's train and decode).

    The collective bytes are pinned as a ratio (port over reference,
    ``COLL_RATIO``), as DTensor and GSPMD part:

    - XLA's CPU backend runs bf16 dots in f32 and reduces their f32
      results: an all-reduce of a product moves twice the port's bytes
      (the prefill cell's all-reduces are exactly half the reference's,
      122880 against 245760);
    - XLA all-reduces the weight gradients and slices them, where
      DTensor reduce-scatters them onto the FSDP layout (train);
    - XLA re-lays q's heads onto the query-sequence split by an
      all-to-all, DTensor on a ``cpu`` mesh by an all-gather and a
      slice (gloo has no all-to-all), and gathers each FSDP weight at
      its use (``dist.sharding.gathered``).
(c) Four gloo CPU processes (``launch.partition.rank_main``, as
    ``tests/_torch_ranks.py``'s are started) run the partitioned prefill
    (K8 through ``local_map``, its plain version on the CPU) and one
    train step (two microbatches, checkpointed layers) of the smoke
    qwen2.5-3b in f32 on a ``(2, 2)`` mesh: the logits, the loss and
    each gradient equal the unpartitioned port's within 1e-5 of their
    largest magnitude, each parameter's AdamW step (at a constant rate of
    0.1) equals the step taken unpartitioned from the same gradients
    within 1e-5 of that leaf's largest change, and each
    rank's ``CommDebugMode`` counts and the cost counter's bytes equal
    the fake-group count of the same program on ``meta``.
(d) ``constrain`` without a mesh and under one is
    ``tests/test_torch_sharding.py::test_constrain_is_a_no_op``; here,
    the other helpers (``view``, ``lookup``, ``write_slice``,
    ``gathered``, ``on_mesh``) without a mesh and on one, and the merged
    ``pod``/``data`` dimension of the multipod mesh.
"""
import dataclasses
import math
import os
import sys

import pytest
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import configs as TC
from repro_torch import hlo_analysis as H
from repro_torch.configs.shapes import ShapeCell
from repro_torch.dist import process
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, partition, tuning
from repro_torch.launch.mesh import fake_device_mesh
from repro_torch.layers.moe import capacity

sys.path.insert(0, os.path.dirname(__file__))
import _torch_partition_jax as PJ  # noqa: E402

#: Port's collective bytes over the reference's, each smoke cell (see the
#: module note), within ``COLL_TOL``.
COLL_RATIO = {("qwen2.5-3b", "train"): 0.6111,
              ("qwen2.5-3b", "prefill"): 0.6309,
              ("qwen2.5-3b", "decode"): 0.8097,
              ("qwen3-moe-30b-a3b", "train"): 0.5847,
              ("qwen3-moe-30b-a3b", "prefill"): 0.6259,
              ("qwen3-moe-30b-a3b", "decode"): 2.1234,
              ("minicpm3-4b", "train"): 0.6239,
              ("minicpm3-4b", "prefill"): 0.4771,
              ("minicpm3-4b", "decode"): 0.8691,
              ("internvl2-2b", "train"): 0.5986,
              ("internvl2-2b", "prefill"): 0.6346,
              ("internvl2-2b", "decode"): 0.8165,
              ("mamba2-2.7b", "train"): 1.075,
              ("mamba2-2.7b", "prefill"): 0.5464,
              ("mamba2-2.7b", "decode"): 0.819,
              ("zamba2-7b", "train"): 0.7798,
              ("zamba2-7b", "prefill"): 0.5539,
              ("zamba2-7b", "decode"): 0.8374,
              ("hubert-xlarge", "train"): 0.408,
              ("hubert-xlarge", "prefill"): 0.4917}
COLL_TOL = 2e-3
RTOL = 1e-3
#: Per-device dot FLOPs the port counts beyond ``analyze_hlo``'s in the
#: cells where GSPMD partitions a product otherwise and the trace has
#: not found where yet: measured, pinned (ROADMAP Queue 1).
UNTRACED = {("qwen3-moe-30b-a3b", "decode"): 52224,
            ("minicpm3-4b", "train"): 917504,
            ("minicpm3-4b", "decode"): 21504}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return PJ.reference(tmp_path_factory)


@pytest.fixture
def mesh():
    with fake_device_mesh(*PJ.MESH) as m:
        yield m


def test_mlp_counts_equal_the_partitioned_compile(ref, mesh):
    def lay(shape, spec):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 shd.placements(spec, mesh),
                                 src_data_rank=None)

    w = lay((6, 256, 512), (None, "data", "model"))
    w2 = lay((6, 512, 256), (None, "model", "data"))
    x = lay((8, 256), (None, "data"))

    def f(w, w2, x):
        c = x
        for i in range(6):
            c = torch.relu(c @ w[i]) @ w2[i]
        return c.sum()

    with shd.use_mesh(mesh):
        out, cost = H.count(f, w, w2, x)
    jax = ref["mlp"]
    assert cost.dot_flops == jax["dot_flops"] == 6 * 2 * 2 * 8 * 256 * 512 / 8
    assert out.placements == (Partial(), Partial())
    ring = {n: (n - 1) / n for n in (2, 4)}
    act = 8 * 512 // 4 * 4        # a layer's hidden block: 8 x 128 f32
    out_blk = 8 * 256 // 2 * 4    # a layer's output block: 8 x 128 f32
    data_ar = 2 * act * ring[2]   # the relu's sum over data
    model_ar = 2 * out_blk * ring[4]  # the next layer's sum over model
    scalar_ar = 2 * 4 * ring[2]   # the loss's sum over data
    assert jax["collective_by_op"] == {
        "all-reduce": 6 * data_ar + 6 * model_ar + scalar_ar}
    assert jax["collective_count"] == 13
    assert cost.collective_by_op == {
        "reduce-scatter": 6 * (act // 2) * (2 - 1),
        "all-gather": 6 * act * ring[2],
        "all-reduce": 5 * model_ar}
    assert cost.collective_count == 17
    assert (cost.collective_by_op["reduce-scatter"]
            + cost.collective_by_op["all-gather"]) == 6 * data_ar
    assert jax["collective_by_op"]["all-reduce"] - cost.collective_bytes \
        == model_ar + scalar_ar


def _cell(arch, kind, mesh):
    cfg = TC.get_smoke_config(arch)
    cfg = dataclasses.replace(
        cfg, remat="full" if kind == "train" else "none",
        **({} if kind == "train" else {"param_dtype": torch.bfloat16}))
    knobs = tuning.CellKnobs(accum_steps=PJ.ACC if kind == "train" else 1)
    cost, _ = dryrun.count_cell(cfg, ShapeCell("t", PJ.S, PJ.B, kind), mesh,
                                knobs)
    return cfg, cost


def _explained(cfg, kind) -> int:
    """The per-device dot FLOPs by which the port's count of a smoke cell
    exceeds ``analyze_hlo``'s, where the module note explains it."""
    data, model = PJ.MESH[0]
    mb = PJ.B // (PJ.ACC if kind == "train" else 1)  # a microbatch
    rows = mb // data                                # its rows a rank
    acc = PJ.ACC if kind == "train" else 1
    d = cfg.d_model
    if cfg.n_experts:
        gs = min(cfg.moe_group_size, mb * PJ.S)
        g, e = mb * PJ.S // gs, cfg.n_experts
        if kind == "train":  # the checkpoint replays the combine product
            return cfg.n_layers * acc * 2 * (g // data) * gs * (e // model) \
                * capacity(gs, cfg) * d
        if kind == "prefill":  # XLA's prefill runs the router whole
            return -cfg.n_layers * 2 * rows * PJ.S * d * e \
                * (model - 1) // model
    if kind == "train" and cfg.family in ("vlm", "encoder"):
        # the input projection's weight gradient: XLA's on its FSDP block
        n_in, tokens = ((cfg.vlm_vision_dim, cfg.vlm_image_tokens)
                        if cfg.family == "vlm"
                        else (cfg.audio_feat_dim, PJ.S))
        return acc * 2 * n_in * rows * tokens * d // data
    if cfg.family in ("ssm", "hybrid") and kind != "decode":
        n_ssm = cfg.n_layers  # zamba2's layers are its Mamba2 layers
        q = min(cfg.ssm_chunk, PJ.S)
        cb = 2 * rows * (PJ.S // q) * cfg.ssm_groups * q * q * cfg.ssm_state
        if kind == "prefill":  # XLA halves the C B^T product
            return n_ssm * cb // 2
        # forward, replay and two gradient products, XLA half of each;
        # less the skip weight's gradient, a dot in XLA's program
        heads = cfg.ssm_heads // model
        skip = 2 * rows * PJ.S * heads * cfg.ssm_head_dim
        return n_ssm * acc * (4 * cb // 2 - skip)
    return 0


@pytest.mark.parametrize("arch,kind", PJ.CELLS)
def test_smoke_cell_per_device_counts(ref, mesh, arch, kind):
    cfg, cost = _cell(arch, kind, mesh)
    jax = ref[f"{arch}/{kind}"]
    extra = UNTRACED.get((arch, kind), _explained(cfg, kind))
    if extra:
        assert cost.dot_flops - jax["dot_flops"] == extra  # exact
    else:
        assert cost.dot_flops == pytest.approx(jax["dot_flops"], rel=RTOL)
    ratio = cost.collective_bytes / jax["collective_bytes"]
    assert ratio == pytest.approx(COLL_RATIO[(arch, kind)], abs=COLL_TOL)
    assert cost.collective_count > 0 and cost.cross_pod_bytes == 0


def test_four_gloo_ranks_run_the_partitioned_program(tmp_path):
    progs = [partition.Program(partition.config(
                 "qwen2.5-3b", attn_impl="flash", attn_chunk=32),
                 "prefill", 4, 64),
             partition.Program(partition.config("qwen2.5-3b"), "train", 4,
                               64, accum_steps=2)]
    process.spawn(partition.rank_main, 4, str(tmp_path), progs, "cpu",
                  timeout_s=300)
    lines = partition.check(progs, str(tmp_path), 4, "cpu", "cpu", 1e-5)
    assert lines[0].startswith("prefill:") and lines[1].startswith("train:")
    fake = partition.fake_collectives(progs[1], "cpu")
    assert fake["counts"] and fake["bytes"]["reduce-scatter"] > 0


def test_helpers_without_a_mesh_and_on_one():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(shd.view(x, (6, 4), ("batch", None)),
                       x.reshape(6, 4))
    table = torch.randn(10, 4)
    ids = torch.tensor([[1, 9], [0, 3]])
    assert torch.equal(shd.lookup(table, ids, ("batch", None, None)),
                       table[ids])
    buf = torch.zeros(2, 8, 3)
    shd.write_slice(buf, 1, 5, torch.ones(2, 2, 3))
    assert buf.sum() == 12 and buf[:, 5:7].eq(1).all()
    assert shd.gathered(x) is x
    with fake_device_mesh((2, 4), ("data", "model")) as mesh:
        def lay(t, pl):
            return distribute_tensor(t.to("meta"), mesh, pl,
                                     src_data_rank=None)
        with shd.use_mesh(mesh):
            # heads split 4 ways, viewed as (kv 2, group 4): the group
            # takes the model axis
            q = lay(torch.empty(4, 16, 8 * 6), [Shard(0), Shard(2)])
            qg = shd.view(q, (4, 16, 2, 4, 6),
                          ("batch", "qseq", "kv_heads", "heads", None))
            assert qg.placements == (Shard(0), Shard(3))
            assert qg.to_local().shape == (2, 16, 2, 1, 6)
            w = lay(torch.empty(16, 8), [Shard(0), Shard(1)])
            assert shd.gathered(w).placements == (Replicate(), Shard(1))
            cache = lay(torch.empty(4, 16, 2, 8), [Shard(0), Shard(1)])
            shd.write_slice(cache, 1, 3,
                            lay(torch.empty(4, 1, 2, 8),
                                [Shard(0), Replicate()]))
            assert cache.placements == (Shard(0), Shard(1))
            emb = shd.lookup(lay(torch.empty(32, 8), [Replicate(), Shard(0)]),
                             lay(torch.zeros(4, 5, dtype=torch.long),
                                 [Shard(0), Replicate()]),
                             ("batch", None, None))
            assert isinstance(emb, DTensor) and emb.shape == (4, 5, 8)
            assert emb.placements == (Shard(0), Replicate())
    assert not torch.distributed.is_initialized()


def test_multipod_mesh_merges_pod_and_data():
    from repro_torch.launch.mesh import production_device_mesh
    with production_device_mesh(multi_pod=True) as mesh:
        assert mesh.mesh_dim_names == ("pod.data", "model")
        assert tuple(mesh.shape) == (32, 16)
        assert shd.axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
        spec = shd.pspec_for(("embed", "mlp"), (2048, 4096), mesh)
        assert spec == (("pod", "data"), "model")
        assert shd.placements(spec, mesh) == (Shard(0), Shard(1))
        with pytest.raises(ValueError, match="part of mesh dimension"):
            shd.placements(("data", None), mesh)
        # a collective over pod x data holds ranks of both pods
        ranks = H._group_ranks(mesh.get_group(0).group_name)
        assert len(ranks) == 32 and {r // 256 for r in ranks} == {0, 1}
        # its ring crosses pods on 2 of its 32 hops
        assert H.cross_pod_share(ranks, 256) == 2 / 32
        assert H.cross_pod_share((3, 259), 256) == 1.0
        assert H.cross_pod_share(range(16), 256) == 0.0
    with production_device_mesh() as mesh:
        assert mesh.mesh_dim_names == ("data", "model")
        assert math.prod(mesh.shape) == 256
