"""One process a shard: the port's distributed stencil over
``torch.distributed`` (gloo, four CPU processes) against the in-process
mesh, the single-device solve and the JAX package; the halo strips, the
rank map and the refusals without processes; every kernel wrapper's
launch on its operands' card; the meshes' default layout over the cards.

The ranks are started once a mesh (``repro_torch.dist.process.spawn``, a
``FileStore`` in a temporary directory), run the whole matrix in
``tests/_torch_ranks.py`` and save their grids; the cases below read them.
"""
import contextlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core import stencil as JS
from repro_torch import engine as TE
from repro_torch.dist import ShardMesh
from repro_torch.dist import mesh as dmesh
from repro_torch.dist import process
from repro_torch.dist.stencil import _assemble_ext, _halo_pairs
from repro_torch.engine import policies
from repro_torch.kernels import build, components, conv1d, flash_attention
from repro_torch.kernels import stream
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import solve

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ranks as R  # noqa: E402

JAX_SPECS = {"jacobi5": JS.jacobi_2d_5pt(),
             "diag9": JS.StencilSpec(offsets=R.DIAG9, weights=(0.125,) * 8)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(mesh)``: the four ranks' saved results on ``mesh``, from
    one spawn a mesh."""
    seen = {}

    def get(mesh_name):
        if mesh_name not in seen:
            out = tmp_path_factory.mktemp(f"ranks{mesh_name}")
            process.spawn(R.work, 4, str(out), mesh_name, timeout_s=120)
            seen[mesh_name] = [torch.load(out / f"rank{k}.pt",
                                          weights_only=False)
                               for k in range(4)]
        return seen[mesh_name]
    return get


def _in_process(mesh_name, u, spec, **kw):
    shape, axes = R.MESHES[mesh_name]
    return TE.run_distributed(u, spec, mesh=ShardMesh(shape, axes,
                                                      ["cpu"] * 4), **kw)


def _same_on_every_rank(res, key) -> torch.Tensor:
    grids = [r[key] for r in res]
    assert all(torch.equal(g, grids[0]) for g in grids[1:]), key
    return grids[0]


@pytest.mark.parametrize("case", R.MATRIX, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_ranks_equal_the_in_process_mesh_and_one_device(ranks, mesh, case):
    spec, policy, t, overlap = case
    got = _same_on_every_rank(ranks(mesh), ("matrix", *case))
    u = torch.from_numpy(R.grid(ring=True))
    kw = dict(policy=policy, iters=R.ITERS, t=t, overlap=overlap)
    assert torch.equal(got, _in_process(mesh, u, R.SPECS[spec], **kw))
    assert torch.equal(got, TE.run(u, R.SPECS[spec], policy="rowchunk",
                                   iters=R.ITERS))


@pytest.mark.parametrize("case", R.JAX_CASES,
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_ranks_match_the_jax_engine(ranks, mesh, case):
    """As ``test_torch_dist.py::test_distributed_matches_the_jax_engine``:
    the reference's ``run_distributed`` raises under newer jax, so the
    ranks are held to its single-device ``engine.run`` (interpret mode)
    within its parity bounds, and to the in-process mesh bit for bit."""
    spec, policy, dtype = case
    got = _same_on_every_rank(ranks(mesh), ("jax", *case))
    a = R.grid(seed=5)
    td = getattr(torch, dtype)
    assert torch.equal(got, _in_process(mesh, torch.from_numpy(a).to(td),
                                        R.SPECS[spec], policy=policy,
                                        iters=7, t=3))
    want = JE.run(jnp.asarray(a).astype(getattr(jnp, dtype)),
                  JAX_SPECS[spec], policy=policy, iters=7, t=3)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_rank_layout_and_traced_rounds(ranks, mesh):
    """Each rank sits at its row-major coordinates, every rank knows every
    rank's device, and with a tracer each rank runs its ``dist.round``
    spans (2 fused rounds and the remainder), bit for bit the untraced
    run."""
    res = ranks(mesh)
    shape, axes = R.MESHES[mesh]
    for k, r in enumerate(res):
        assert r["backend"] == "gloo" and r["devices"] == ["cpu"] * 4
        assert tuple(r["coords"][a] for a in axes) == process.rank_coords(
            shape, k)
        for overlap in (False, True):
            assert r[("traced", overlap)] == (True, 3, 3)


def test_cli_runs_one_shard_a_rank(ranks):
    """``launch.solve --devices 4`` under four ranks: rank 0 prints the
    layout, the bit-for-bit check and CHECK OK; the others print
    nothing."""
    res = ranks("4")
    out = res[0]["cli"]
    assert "mesh=4x1 4 ranks over gloo on [cpu, cpu, cpu, cpu]" in out
    assert ("temporal: 19 sweeps = 2 x t=8 + 3 (rowchunk); 3 exchanges "
            "(halo depth 8)" in out)
    assert "bit for bit" in out and "CHECK OK" in out
    assert all(r["cli"] == "" for r in res[1:])


class _FakeMesh:
    """What :class:`process.RankLayout` reads of a ProcessMesh, for rank
    ``rank`` of a mesh of ``shape`` over ``axes``, without a group."""

    def __init__(self, shape, axes, rank):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.coords = dict(zip(axes, process.rank_coords(shape, rank)))
        self.backend, self.group = "gloo", None
        self.device_here = torch.device("cpu")
        self.devices = (self.device_here,) * int(np.prod(shape))

    def rank_of(self, **coords):
        return dmesh.flat_index(self.shape, self.axis_names, coords)

    def global_rank(self, rank):
        return rank


@pytest.mark.parametrize("shape,axes", [((4,), ("x",)), ((2, 2), ("x", "y")),
                                        ((3, 2), ("x", "y")),
                                        ((1, 3), ("x", "y"))])
@pytest.mark.parametrize("d", [1, 3])
def test_packed_strips_equal_the_halo_pairs(shape, axes, d):
    """Every rank's packed strips, delivered to the neighbour they are
    addressed to and unpacked phase by phase, give the blocks the
    in-process exchange's ``_halo_pairs`` copies give."""
    world = int(np.prod(shape))
    px, py = (shape + (1,))[:2]
    g = torch.Generator().manual_seed(d)
    interior = torch.rand((6 * px, 7 * py), generator=g)
    bands = [torch.rand(s, generator=g) for s in
             [(1, 7 * py)] * 2 + [(6 * px, 1)] * 2 + [(1, 1)] * 4]
    layouts = [process.RankLayout.of(_FakeMesh(shape, axes, k), axes[0],
                                     axes[1] if len(axes) > 1 else None,
                                     interior.shape) for k in range(world)]
    shards = [lay.split(interior)[0] for lay in layouts]
    want = _assemble_ext(shards, *bands, px=px, py=py, r=1, d=d)
    got = [e.clone() for e in want]
    for dst, src in _halo_pairs(want, px=px, py=py, d=d):
        dst.copy_(src)
    halos = [lay.exchanger(d)([e]) for lay, e in zip(layouts, got)]
    for i in range(2):
        for h in halos:
            h.pack(i)
        for k, h in enumerate(halos):
            for (peer, _, _), (_, rbuf) in zip(h.phases[i], h.bufs[i]):
                theirs = halos[peer]
                j = [p for p, _, _ in theirs.phases[i]].index(k)
                rbuf.copy_(theirs.bufs[i][j][0])
        for h in halos:
            h.unpack(i)
    for k in range(world):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("shape", [(4,), (2, 2), (2, 3), (2, 2, 2), (5, 1)])
def test_rank_coords_are_the_shard_mesh_order(shape):
    axes = tuple("abc"[:len(shape)])
    sizes = dict(zip(axes, shape))
    for k in range(int(np.prod(shape))):
        coords = dict(zip(axes, process.rank_coords(shape, k)))
        assert dmesh.flat_index(sizes, axes, coords) == k


def test_process_mesh_of_one_rank(tmp_path):
    """A one-rank gloo group in this process: the mesh's rank, coordinates
    and devices; a shape the world does not fill raises."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="init_process_group"):
        process.ProcessMesh((1,), ("x",), device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = process.ProcessMesh((1, 1), ("x", "y"), device="cpu")
        assert (mesh.rank, mesh.coords, mesh.backend) == (
            0, {"x": 0, "y": 0}, "gloo")
        assert mesh.devices == (torch.device("cpu"),)
        assert mesh.device(x=0) == torch.device("cpu")
        with pytest.raises(ValueError, match="process group has 1 ranks"):
            process.ProcessMesh((2,), ("x",), device="cpu")
        u = torch.from_numpy(R.grid(16, 32, seed=4))
        got = TE.run_distributed(u, mesh=mesh, policy="temporal", iters=6,
                                 t=3)
        assert torch.equal(got, TE.run(u, policy="rowchunk", iters=6))
    finally:
        dist.destroy_process_group()


def test_nccl_refuses_ranks_that_share_a_card():
    cuda0 = torch.device("cuda:0")
    with pytest.raises(ValueError, match="one rank a card.*gloo"):
        process.check_backend("nccl", cuda0, local_ranks=4, cards=1)
    with pytest.raises(ValueError, match="gloo"):
        process.check_backend("nccl", torch.device("cpu"), 1, 0)
    with pytest.raises(ValueError, match="runs over"):
        process.check_backend("mpi", cuda0, 1, 1)
    process.check_backend("nccl", cuda0, local_ranks=4, cards=4)
    process.check_backend("gloo", cuda0, local_ranks=4, cards=1)


def test_cli_devices_must_equal_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="--devices 2 != WORLD_SIZE 4"):
        solve.main(["--devices", "2", "--device", "cpu", "--ny", "14",
                    "--nx", "30", "--iters", "3"])


# --- every launch on its operands' card (the loader and the card faked) ---

class _Recorder:
    """Fakes ``torch.cuda.device`` (records the device made current),
    ``torch.cuda.current_stream`` (stream handle 7) and ``build.load`` (a
    library whose every function records the current device and the
    stream it was given, and returns 0)."""

    def __init__(self):
        self.current, self.calls = [], []

    @contextlib.contextmanager
    def device(self, dev):
        self.current.append(torch.device(dev))
        try:
            yield
        finally:
            self.current.pop()

    def load(self, name="stencil", *_):
        rec = self

        class Lib:
            def __getattr__(self, fn):
                def call(*args):
                    rec.calls.append((fn, rec.current[-1] if rec.current
                                      else None, args[-1]))
                    return 0
                return call
        return Lib()


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(build, "load", rec.load)
    monkeypatch.setattr(policies, "_sm_count", lambda dev: 132)
    return rec


def _stencil(policy, **kw):
    """Launch ``policy``'s kernel on ``u`` through ``policies.launch``
    (K1 with a pin mask)."""
    def run(u):
        plan = TE.plan_for(u.shape, u.dtype, R.SPECS["jacobi5"], policy,
                           device="gpu_sm90", masked="t" in kw, **kw)
        mask = torch.zeros(u.shape, dtype=torch.uint8) if "t" in kw else None
        policies.launch(plan, u, mask=mask)
    return run


LAUNCHERS = {
    "K1": _stencil("temporal", t=2), "K2": _stencil("rowchunk"),
    "K3": _stencil("dbuf"), "K4": _stencil("shifted"),
    "K7": lambda u: conv1d._launch(u[None, :32, :8].contiguous(),
                                   u[:4, :8].contiguous(),
                                   u[0, :8].contiguous(), 32),
    "K5a": lambda u: stream._launch("stream_copy", "repro_stream_copy", u,
                                    4, 8, 8, 1, 1, 1, 1, 1),
    "K6a": lambda u: components._launch("dma_only", "repro_dma_only", u,
                                        torch.empty_like(u), 4, 8, 8, 8),
    "K8": lambda u: flash_attention._launch(
        *(torch.zeros((1, 64, 2, 64), dtype=d) for d in [torch.bfloat16] * 3),
        True),
    "K8 f32": lambda u: flash_attention._launch(
        *(torch.zeros((1, 64, 2, 64)) for _ in range(3)), True),
}


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_every_launch_runs_on_its_operands_card(recorder, name):
    """Each wrapper's launch goes through ``build.on_card``: the library
    is called with the operands' device current and that device's stream
    (the card is faked: on the CPU the wrappers run their plain versions,
    so the launchers are called directly)."""
    u = torch.rand((40, 64))
    LAUNCHERS[name](u)
    assert recorder.calls, name
    for fn, dev, stream_arg in recorder.calls:
        assert (dev, stream_arg) == (u.device, 7), (fn, dev, stream_arg)


def test_the_l2_probe_runs_on_its_operands_card(recorder, monkeypatch):
    monkeypatch.setattr(stream, "_device", lambda x: "cuda")
    stream.l2_read_probe(torch.zeros(64, dtype=torch.int32), passes=1)
    assert recorder.calls == [("repro_l2_probe", torch.device("cpu"), 7)]


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_operands_on_two_devices_are_refused(recorder, monkeypatch, name):
    """An output on another device than the inputs: every launcher
    refuses before the library is called."""
    real = torch.empty_like
    monkeypatch.setattr(torch, "empty_like",
                        lambda x, **kw: real(x, device="meta", **kw))
    with pytest.raises(ValueError, match="one card|out's dtype and device"):
        LAUNCHERS[name](torch.rand((40, 64)))
    assert recorder.calls == []


def test_launch_device_names_the_devices():
    a, b = torch.zeros(2), torch.zeros(2, device="meta")
    assert build.launch_device(a, None, a) == torch.device("cpu")
    with pytest.raises(ValueError, match=r"one card; got \['cpu', 'meta'\]"):
        build.launch_device(a, b)


# --- the meshes' default layout over the cards present ---

@pytest.mark.parametrize("cards,want", [
    (1, ["cuda:0"] * 4), (2, ["cuda:0", "cuda:1"] * 2),
    (4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])])
def test_default_mesh_spreads_over_the_cards(monkeypatch, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    want = [torch.device(d) for d in want]
    assert list(ShardMesh((4,), ("x",)).devices) == want
    assert list(ShardMesh((2, 2), ("x", "y")).devices) == want
    assert list(lmesh.make_mesh((4,), ("x",)).devices) == want
    assert dmesh.default_devices(4) == [str(d) for d in want]


def test_default_mesh_without_a_card_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dmesh.default_devices(2) == ["cuda", "cuda"]
    with pytest.raises(RuntimeError, match="cuda"):
        ShardMesh((2,), ("x",))
