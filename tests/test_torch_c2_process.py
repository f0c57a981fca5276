"""The sharded LM pieces one process a shard: the collectives of
``repro_torch.dist.process`` over ``torch.distributed`` (gloo, four CPU
processes) against the in-process pieces of ``tests/test_torch_c2.py``
and the JAX package, on the JAX script's seeded inputs
(``tests/_torch_c2_jax.py``, one subprocess a test run, shared with that
file); then what needs no processes: the order of the mesh's subgroups,
``psum``'s order, and the refusals.

The ranks are started once a mesh (``dist.process.spawn``, a
``FileStore`` in a temporary directory) and run ``tests/_torch_c2_ranks.
py``: on ``(2, 2)`` the sharded K8 (its plain version on the CPU) and
``remesh_state`` from ``(2, 2)`` onto ``(2,)`` over ranks 0-1; on
``(4,)`` ``ppermute``, ``all_gather``, ``psum``, the pipeline (a stage a
rank, forward and gradients), the sequence-parallel SSD, the conv halo,
``compressed_psum`` and ``python -m repro_torch.launch.sharded``. Every
piece is bit for bit its in-process counterpart, and within
``tests/test_torch_c2.py``'s bounds of the JAX package. The pipeline's
gradients are bit for bit too: each rank sums a parameter's microbatch
gradients from the last microbatch to the first, the order autograd
sums them in through the in-process pipeline.
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import ssm_sp
from repro_torch.dist import ShardMesh
from repro_torch.dist import process
from repro_torch.dist import sharding as shd
from repro_torch.dist.pipeline import pipeline_forward, split_stages
from repro_torch.kernels import ops
from repro_torch.kernels.conv1d import conv1d_depthwise_causal
from repro_torch.train.compression import EFState, compressed_psum
from repro_torch.train.fault import remesh_state
from repro_torch.train.trainstep import TrainState

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_c2_jax  # noqa: E402
import _torch_c2_ranks as R  # noqa: E402

CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _torch_c2_jax.reference(tmp_path_factory)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """``ranks(mesh)``: the four ranks' saved results on ``mesh`` ("2x2"
    or "4"), from one spawn a mesh."""
    seen = {}

    def get(mesh_name):
        if mesh_name not in seen:
            out = tmp_path_factory.mktemp(f"c2ranks{mesh_name}")
            process.spawn(R.work, 4, str(out), mesh_name, ref["npz"],
                          timeout_s=120)
            seen[mesh_name] = [torch.load(out / f"rank{k}.pt",
                                          weights_only=False)
                               for k in range(4)]
        return seen[mesh_name]
    return get


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_collectives_across_four_ranks(ranks):
    """``ppermute`` delivers along its pairs and zeros the rank that
    receives nothing; ``all_gather`` is in axis order; ``psum`` adds in
    axis order, the same on every rank."""
    res = ranks("4")
    sent = {dst: src for src, dst in R.PERM}
    for k, r in enumerate(res):
        assert r["backend"] == "gloo"
        want = (torch.full((3,), float(sent[k] + 1)) if k in sent
                else torch.zeros(3))
        assert torch.equal(r["ppermute"], want), k
        assert [float(p[0]) for p in r["all_gather"]] == [1.0, 2.0, 3.0, 4.0]
        assert float(r["psum"]) == 1.0  # ((1e8 + 1) - 1e8) + 1


def test_sharded_flash_one_rank_a_shard(ref, ranks):
    """K8 (its plain version here) under ``use_mesh`` of a ``(2, 2)``
    process mesh: each rank runs its batch half and KV head, and every
    rank gets the whole result, bit for bit the in-process mesh's and
    within 2e-5 of the JAX sharded call."""
    q, k, v = (_t(ref[n]) for n in ("fa_q", "fa_k", "fa_v"))
    with shd.use_mesh(ShardMesh((2, 2), ("data", "model"), CPU4)):
        want = ops.flash_attention(q, k, v, causal=True, bq=64, bk=64)
    res = ranks("2x2")
    for k, r in enumerate(res):
        assert tuple(r["coords"].values()) == process.rank_coords((2, 2), k)
        assert torch.equal(r["fa"], want), k
        np.testing.assert_allclose(r["fa"].numpy(), ref["fa_y"], rtol=2e-5,
                                   atol=2e-5)


def test_ssd_and_conv_halo_one_rank_a_shard(ref, ranks):
    """The sequence-parallel SSD (all-gathered decays and states) and the
    conv halo (one ``ppermute`` hop, zeros on shard 0) then the causal
    conv: each rank's shard bit for bit the in-process shard; the SSD
    within 2e-4 and the conv within 1e-4 of the JAX ones."""
    mesh = ShardMesh((4,), ("sp",), CPU4)
    x, dt, a, b, c = (_t(ref[k]) for k in ("ssd_x", "ssd_dt", "ssd_a",
                                           "ssd_b", "ssd_c"))
    parts = [shd.lay_out(t, (None, "sp"), mesh).shards for t in (x, dt, b, c)]
    ys = ssm_sp.ssd_sequence_parallel(*parts[:2], a, *parts[2:], 32)
    xc, wc = _t(ref["conv_x"]), _t(ref["conv_w"])
    ext = ssm_sp.conv_halo_exchange(
        shd.lay_out(xc, (None, "sp"), mesh).shards, 4)
    res = ranks("4")
    for k, r in enumerate(res):
        assert torch.equal(r["ssd"], ys[k]), k
        assert torch.equal(r["conv_ext"], ext[k]), k
        assert torch.equal(r["conv"], conv1d_depthwise_causal(
            ext[k], wc)[:, 3:]), k
    got = torch.cat([r["ssd"] for r in res], 1)
    assert float((got - _t(ref["ssd_y"])).abs().max()) < 2e-4
    got_c = torch.cat([r["conv"] for r in res], 1)
    assert torch.equal(got_c, conv1d_depthwise_causal(xc, wc))
    assert float((got_c - _t(ref["conv_y"])).abs().max()) < 1e-4


def test_pipeline_one_rank_a_stage(ref, ranks):
    """The 4-stage pipeline of the reference test's tanh MLP, stage ``s``
    on rank ``s``: every rank's result bit for bit the in-process
    pipeline's (with grad and without), within 2e-5 of the JAX pipeline;
    each rank's stage gradients bit for bit the in-process pipeline's
    slab for that stage and within 5e-4 / 5e-5 of ``jax.grad``."""
    w = _t(ref["pipe_w"]).requires_grad_(True)
    x = _t(ref["pipe_x"])
    pipe = pipeline_forward(R.stage_fn, ShardMesh((4,), ("stage",), CPU4))
    y = pipe(split_stages({"w": w}, 4), x)
    (g,) = torch.autograd.grad(torch.sum(y ** 2), [w])
    g = g.reshape(4, 2, *g.shape[1:])
    for k, r in enumerate(ranks("4")):
        assert torch.equal(r["pipe_y"], y.detach()), k
        assert torch.equal(r["pipe_y_nograd"], y.detach()), k
        assert torch.equal(r["pipe_g"], g[k]), k
    np.testing.assert_allclose(y.detach().numpy(), ref["pipe_y"], rtol=2e-5,
                               atol=2e-5)
    got = torch.cat([r["pipe_g"] for r in ranks("4")])
    np.testing.assert_allclose(got.numpy(), ref["pipe_g"], rtol=5e-4,
                               atol=5e-5)


def test_pipeline_of_modules_one_rank_a_stage(ref, ranks):
    """The same schedule over a list of modules, each rank given its
    stage's modules: the result and every parameter's gradient bit for
    bit the in-process pipeline's."""
    layers = R.linear_layers()
    x = _t(ref["pipe_x"])
    pipe = pipeline_forward(R.module_stage_fn,
                            ShardMesh((4,), ("stage",), CPU4))
    y = pipe(split_stages(layers, 4), x)
    params = [p for layer in layers for p in layer.parameters()]
    grads = torch.autograd.grad(torch.sum(y ** 2), params)
    per = len(params) // 4
    for k, r in enumerate(ranks("4")):
        assert torch.equal(r["pipe_mod_y"], y.detach()), k
        mine = grads[k * per:(k + 1) * per]
        assert len(r["pipe_mod_g"]) == per
        assert all(torch.equal(a, b) for a, b in zip(r["pipe_mod_g"], mine))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compressed_psum_one_rank_a_replica(ref, ranks, mode):
    """Each rank's mean and residual bit for bit the in-process call's
    entry for that replica (int8 payloads and f32 scales, or bf16
    values, gathered and summed in rank order), and within
    ``tests/test_torch_c2.py``'s bounds of the JAX ``compressed_psum``."""
    g, r = _t(ref["cp_g"]), _t(ref["cp_r"])
    means, efs = compressed_psum([{"w": g[i]} for i in range(4)],
                                 [EFState({"w": r[i]}) for i in range(4)],
                                 mode)
    ulp = 2.0 ** (-23 if mode == "int8" else -8)
    f32_ulp = float((g + r).abs().max()) * 2.0 ** -23
    for k, rk in enumerate(ranks("4")):
        mean, res = rk[f"cp_{mode}"]
        assert torch.equal(mean, means[k]["w"]), k
        assert torch.equal(res, efs[k].residual["w"]), k
        np.testing.assert_allclose(res.numpy(), ref[f"cp_{mode}_res"][k],
                                   rtol=0, atol=f32_ulp)
        np.testing.assert_allclose(mean.numpy(), ref[f"cp_{mode}_mean"][k],
                                   rtol=0,
                                   atol=float(mean.abs().max()) * 4 * ulp)


def _block_rows(full, spec, mesh, i, data):
    sl = shd.block_slices(full.shape, spec, mesh, shd._coords(mesh, i))
    return [i, [[s.start, s.stop] for s in sl], data.tolist()]


def test_remesh_state_onto_a_subgroup(ref, ranks):
    """``remesh_state`` from ``(2, 2)`` over four ranks onto ``(2,)`` over
    ranks 0-1: on the old mesh each rank holds the in-process shard of
    its index; on the new one ranks 0-1 hold the in-process ``(2,)``
    shards, equal to the JAX ``remesh_state``'s blocks on devices 0-1,
    and gather the original bit for bit; ranks 2-3 hold no block and a
    collective there is refused."""
    w, b = _t(ref["rm_w"]), _t(ref["rm_b"])
    state = TrainState({"w": w, "b": b}, {"step": torch.tensor(3)})
    square = ShardMesh((2, 2), ("data", "model"), CPU4)
    cur = remesh_state(state, square, R.RM_SPECS)
    small = ShardMesh((2,), ("data",), ["cpu"] * 2)
    new = remesh_state(cur, small, R.RM_SPECS)
    res = ranks("2x2")
    for k, r in enumerate(res):
        for name, leaf in [*cur.params.items(),
                           ("step", cur.opt_state["step"])]:
            spec, shards = r["rm_22"][name]
            assert spec == leaf.spec and len(shards) == 1
            assert torch.equal(shards[0], leaf.shards[k]), (k, name)
        if k < 2:
            assert r["rm_2_rank"] == k
            for name, leaf in [*new.params.items(),
                               ("step", new.opt_state["step"])]:
                spec, shards = r["rm_2"][name]
                assert spec == leaf.spec and len(shards) == 1
                assert torch.equal(shards[0], leaf.shards[k]), (k, name)
            for name, full in (("w", w), ("b", b)):
                assert torch.equal(r["rm_2_full"][name], full)
                want = ref["blocks"][f"(2,)/{name}"][k]
                assert _block_rows(full, new.params[name].spec, small, k,
                                   r["rm_2"][name][1][0]) == want
        else:
            assert r["rm_2_rank"] is None
            assert all(shards == [] for _, shards in r["rm_2"].values())
            assert "holds no shard" in r["outside"]


def test_the_launcher_one_rank_a_shard(ranks):
    """``python -m repro_torch.launch.sharded --device cpu`` on the four
    ranks (as under ``torch.distributed.run``): rank 0 prints every
    piece bit for bit the in-process one and ``SHARDED OK``; the others
    print nothing."""
    res = ranks("4")
    out = res[0]["cli"]
    assert out.startswith("4 ranks over gloo on cpu")
    assert out.count("[True, True, True, True]") == 8
    assert out.rstrip().endswith("SHARDED OK")
    assert all(r["cli"] == "" for r in res[1:])


def test_the_launcher_wants_four_ranks(monkeypatch):
    from repro_torch.launch import sharded
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--nproc-per-node 4"):
        sharded.main(["--device", "cpu"])


@pytest.mark.parametrize("shape,want", [
    ((4,), [("a", (0, 1, 2, 3))]),
    ((2, 2), [("a", (0, 2)), ("a", (1, 3)), ("b", (0, 1)), ("b", (2, 3))]),
    ((2, 2, 1), [("a", (0, 2)), ("a", (1, 3)), ("b", (0, 1)), ("b", (2, 3)),
                 ("c", (0,)), ("c", (1,)), ("c", (2,)), ("c", (3,))])])
def test_subgroups_are_made_in_one_order(shape, want):
    """Every rank creates the line subgroups in this order: axis by
    axis, lines by their first rank, each line in axis order."""
    assert process.axis_lines(shape, tuple("abc"[:len(shape)])) == want


def test_psum_adds_in_axis_order(monkeypatch):
    """``psum`` adds the gathered tensors left to right in axis order: in
    f32 ``((1e8 + 1) - 1e8) + 1`` is 1, where summing from the right or
    pairwise gives 0 or 2."""
    parts = [torch.tensor(v) for v in R.PSUM_VALUES]
    monkeypatch.setattr(process, "all_gather", lambda t, mesh, axis: parts)
    assert float(process.psum(parts[0], None, "x")) == 1.0
    monkeypatch.setattr(process, "all_gather",
                        lambda t, mesh, axis: parts[::-1])
    assert float(process.psum(parts[0], None, "x")) == 0.0


def test_one_rank_mesh_and_calls_without_a_group(tmp_path):
    """On a one-rank gloo group: ``ppermute`` with no pair to this rank
    gives zeros, ``all_gather`` and ``psum`` give the rank's own tensor,
    a mesh over ranks the world lacks is refused; once the group is gone,
    every collective of the mesh raises, naming
    ``init_process_group``."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = process.ProcessMesh((1,), ("x",), device="cpu")
        t = torch.arange(3.0)
        assert torch.equal(process.ppermute(t, mesh, "x", []),
                           torch.zeros(3))
        assert torch.equal(process.all_gather(t, mesh, "x")[0], t)
        assert torch.equal(process.psum(t, mesh), t)
        with pytest.raises(ValueError, match="at most once"):
            process.ppermute(t, mesh, "x", [(0, 1)])
        with pytest.raises(ValueError, match="increasing ranks"):
            process.ProcessMesh((1,), ("x",), ranks=[1], device="cpu")
    finally:
        dist.destroy_process_group()
    pipe = pipeline_forward(R.stage_fn, mesh, axis="x")
    for call in (lambda: process.all_gather(t, mesh),
                 lambda: process.psum(t, mesh, "x"),
                 lambda: process.ppermute(t, mesh, "x", []),
                 lambda: shd.lay_out(t, (None,), mesh),
                 lambda: shd.shard_call(lambda a: a, mesh, (t,), ((None,),),
                                        (None,)),
                 lambda: pipe({"w": torch.zeros((1, 3, 3))}, t[None, None]),
                 lambda: ssm_sp.conv_halo_exchange(t[None, :, None], 2,
                                                   mesh=mesh, axis="x"),
                 lambda: ssm_sp.ssd_sequence_parallel(
                     t, t, t, t, t, 1, mesh=mesh, axis="x"),
                 lambda: compressed_psum({"w": t}, EFState({"w": t}),
                                         mesh=mesh, axis="x")):
        with pytest.raises(RuntimeError, match="init_process_group"):
            call()


def test_nccl_mesh_on_a_shared_card_is_refused(tmp_path, monkeypatch):
    """A mesh over NCCL with more local ranks than cards raises at
    construction, naming gloo (the backend and the card faked)."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        monkeypatch.setattr(process, "rank_device",
                            lambda: torch.device("cuda:0"))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
        with pytest.raises(ValueError, match="one rank a card.*gloo"):
            process.ProcessMesh((1,), ("x",))
    finally:
        dist.destroy_process_group()


def test_a_failing_rank_fails_spawn():
    """A rank that raises while the other waits on it in a ``psum``:
    ``spawn`` stops the other and raises (with whichever rank's error it
    saw first: rank 1's, or rank 0's lost connection)."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails|Connection closed"):
        process.spawn(R.fail_on_rank_one, 2, timeout_s=60)
