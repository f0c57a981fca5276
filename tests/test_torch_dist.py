"""The port's distributed stencil against its single-device solve and the
JAX package's.

On CPU shards of a :class:`~repro_torch.dist.ShardMesh`:

* the reference test's matrix (``tests/test_dist_engine.py``): jacobi5,
  a row stencil and a diagonal-tap one, meshes ``(4,)`` and ``(2, 2)``,
  the policies ``reference``, ``shifted``, ``rowchunk`` and ``temporal``,
  ``t`` 1 and 3, overlap on and off — each ``torch.equal`` to the port's
  single-device ``engine.run(policy="rowchunk")`` in f32 (dyadic weights);
* the distributed solve against ``repro.engine.run`` in interpret mode,
  within ``tests/test_engine.py``'s bounds (f32 1e-6, bf16 2e-2);
* rounds of the port's ``make_sharded_step`` against the reference's
  ``make_sharded_step`` + ``masked_block(apply_stencil)`` over forced
  host devices, bit for bit, in one subprocess (the reference's whole
  ``run_distributed`` raises under newer jax, ROADMAP Queue 3);
* the traced executor's spans and bills, the depth check, the legacy
  ``core.halo`` front door, ``ShardMesh`` and ``core.decomp``.
"""
import functools
import itertools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core import decomp as JD
from repro.core import stencil as JS
from repro_torch import engine as TE
from repro_torch.core import decomp as TD
from repro_torch.core import halo as TH
from repro_torch.core import stencil as TS
from repro_torch.dist import ShardMesh, make_sharded_step, masked_block
from repro_torch.interop import grid_from_numpy, grid_to_numpy
from repro_torch.obs.compare import reconcile
from repro_torch.obs.trace import Tracer, use_tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAG9 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))
ROW3 = ((0, -1), (0, 0), (0, 1))
SPECS = {
    "jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
    "diff3": (JS.StencilSpec(offsets=ROW3, weights=(0.25, 0.5, 0.25)),
              TS.StencilSpec(offsets=ROW3, weights=(0.25, 0.5, 0.25))),
    "diag9": (JS.StencilSpec(offsets=DIAG9, weights=(0.125,) * 8),
              TS.StencilSpec(offsets=DIAG9, weights=(0.125,) * 8)),
}
MESHES = {"4": ((4,), ("x",)), "2x2": ((2, 2), ("x", "y"))}
ITERS = 6


def _mesh(name):
    shape, axes = MESHES[name]
    return ShardMesh(shape, axes, ["cpu"] * 4)


def _grid(ny=32, nx=64, seed=0, ring=False) -> np.ndarray:
    """A ringed grid: the Laplace problem's ring (or a random one) around
    a random interior."""
    rng = np.random.default_rng(seed)
    a = np.zeros((ny + 2, nx + 2), np.float32)
    a[:, 0] = 1.0
    if ring:
        a[0, :], a[-1, :] = rng.uniform(0, 1, (2, nx + 2))
        a[:, 0], a[:, -1] = rng.uniform(0, 1, (2, ny + 2))
    a[1:-1, 1:-1] = rng.uniform(0, 1, (ny, nx))
    return a


@functools.lru_cache(maxsize=None)
def _single(spec_name: str) -> torch.Tensor:
    u = grid_from_numpy(_grid(ring=True), device="cpu")
    return TE.run(u, SPECS[spec_name][1], policy="rowchunk", iters=ITERS)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("policy", ["reference", "shifted", "rowchunk",
                                    "temporal"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("spec", list(SPECS))
def test_distributed_equals_single_device_bitwise(spec, mesh, policy, t,
                                                  overlap):
    u = grid_from_numpy(_grid(ring=True), device="cpu")
    sched, _, _ = TE.plan_distributed(u.shape, u.dtype, SPECS[spec][1],
                                      mesh=_mesh(mesh), policy=policy,
                                      iters=ITERS, t=t, overlap=overlap)
    assert sched.overlap is overlap and sched.t == t
    assert sched.exchanges == ITERS // t
    got = TE.run_distributed(u, SPECS[spec][1], mesh=_mesh(mesh),
                             policy=policy, iters=ITERS, t=t,
                             overlap=overlap)
    assert torch.equal(got, _single(spec))


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_fused_with_a_remainder_round(mesh, t):
    """A fused main policy with a remainder: iters // t masked K1 rounds
    plus one shallower rowchunk round, exchanges counted as the schedule
    says, the result bit for bit."""
    u = grid_from_numpy(_grid(seed=3), device="cpu")
    spec = SPECS["diag9"][1]
    iters = 7
    sched, _, _ = TE.plan_distributed(u.shape, u.dtype, spec,
                                      mesh=_mesh(mesh), policy="temporal",
                                      iters=iters, t=t)
    nfull, rem = divmod(iters, t)
    assert (sched.fused_blocks, sched.remainder, sched.remainder_policy,
            sched.exchanges) == (nfull, rem, "rowchunk", nfull + 1)
    for overlap in (None, True, False):
        got = TE.run_distributed(u, spec, mesh=_mesh(mesh),
                                 policy="temporal", iters=iters, t=t,
                                 overlap=overlap)
        assert torch.equal(got, TE.run(u, spec, policy="rowchunk",
                                       iters=iters))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["temporal", "rowchunk"])
@pytest.mark.parametrize("spec", ["jacobi5", "diag9"])
def test_distributed_matches_the_jax_engine(spec, policy, dtype):
    """The port's distributed solve against ``repro.engine.run`` of the
    same policy (interpret mode), within the reference's parity bounds."""
    a = _grid(seed=5)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = JE.run(jnp.asarray(a).astype(jd), SPECS[spec][0], policy=policy,
                  iters=7, t=3)
    got = TE.run_distributed(grid_from_numpy(a, device="cpu").to(td),
                             SPECS[spec][1], mesh=_mesh("2x2"),
                             policy=policy, iters=7, t=3)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(grid_to_numpy(got.to(torch.float32)),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


SHARDED_STEP_SCRIPT = r"""
import jax, jax.numpy as jnp, numpy as np, torch
from repro.core import stencil as JS
from repro.dist import stencil as JD
from repro_torch import engine as TE
from repro_torch.core import stencil as TS
from repro_torch.dist import ShardMesh, make_sharded_step, masked_block

rng = np.random.default_rng(0)
a = rng.uniform(0, 1, (34, 66)).astype(np.float32)   # random ring too
r, T, ROUNDS = 1, 3, 3
bands = {"top": a[:r, r:-r], "bottom": a[-r:, r:-r], "left": a[r:-r, :r],
         "right": a[r:-r, -r:], "tl": a[:r, :r], "tr": a[:r, -r:],
         "bl": a[-r:, :r], "br": a[-r:, -r:]}
jb = {k: jnp.asarray(v) for k, v in bands.items()}
tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in bands.items()}
diag9 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))
specs = {"jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
         "diag9": (JS.StencilSpec(offsets=diag9, weights=(0.125,) * 8),
                   TS.StencilSpec(offsets=diag9, weights=(0.125,) * 8))}
fails = 0
for name, (js, ts) in specs.items():
    for shape, axes in (((4,), ("x",)), ((2, 2), ("x", "y"))):
        jmesh = jax.make_mesh(shape, axes)
        tmesh = ShardMesh(shape, axes, ["cpu"] * 4)
        row, col = axes[0], (axes[1] if len(axes) > 1 else None)
        py = shape[1] if len(shape) > 1 else 1
        ext = (32 // shape[0] + 2 * T, 64 // py + 2 * T)
        for overlap in (False, True):
            jstep = jax.jit(JD.make_sharded_step(
                jmesh, js, JD.masked_block(lambda e: JS.apply_stencil(e, js)),
                row_axis=row, col_axis=col, t=T, overlap=overlap))
            blocks = {
                "masked_block(apply_stencil)":
                    masked_block(lambda e: TS.apply_stencil(e, ts)),
                "masked K1": TE.local_sweep_for(
                    "temporal", ts, shard_shape=ext, dtype=torch.float32,
                    t=T, torch_device="cpu")}
            steps = {k: make_sharded_step(tmesh, ts, b, row_axis=row,
                                          col_axis=col, t=T, overlap=overlap)
                     for k, b in blocks.items()}
            ju = jnp.asarray(a[1:-1, 1:-1])
            tu = {k: torch.from_numpy(a[1:-1, 1:-1].copy()) for k in blocks}
            for i in range(ROUNDS):
                ju = jstep(ju, jb)
                for k, step in steps.items():
                    tu[k] = step(tu[k], tb)
                    ok = np.array_equal(tu[k].numpy(), np.asarray(ju))
                    fails += not ok
                    print(("ok   " if ok else "FAIL ") + f"{name} {shape} "
                          f"overlap={overlap} {k} round {i}")
assert fails == 0, f"{fails} rounds differ"
print("SHARDED STEP OK")
"""


def test_sharded_step_rounds_equal_the_reference_bitwise():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", SHARDED_STEP_SCRIPT],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, f"\n{proc.stdout}\n{proc.stderr}"
    assert "SHARDED STEP OK" in proc.stdout
    assert proc.stdout.count("ok   ") == 48


@pytest.mark.parametrize("overlap", [False, True])
def test_traced_run_is_bit_identical_and_carries_the_bill(overlap):
    """With a tracer the rounds run phase by phase: the same result, one
    ``dist.round`` a round, each phase span carrying its round's bill."""
    u = TS.make_laplace_problem(34, 130, device="cpu")
    spec = TS.jacobi_2d_5pt()
    kw = dict(mesh=ShardMesh((2,), ("x",), ["cpu"] * 2), policy="temporal",
              iters=10, t=4, overlap=overlap)
    off = TE.run_distributed(u, spec, **kw)
    tracer = Tracer()
    with use_tracer(tracer):
        on = TE.run_distributed(u, spec, **kw)
    assert torch.equal(on, off)
    names = [e.name for e in tracer.events]
    assert names.count("dist.round") == 3, names  # 2 fused + remainder
    want = {"interior", "rind"} if overlap else {"compute"}
    assert want <= set(names), (overlap, names)
    exchanges = [e for e in tracer.events if e.name == "exchange"]
    assert len(exchanges) == 3
    for ev in exchanges:
        assert ev.attrs["model_s"] > 0
        assert ev.attrs["halo_bytes"] > 0
        assert ev.attrs["model_exchange_s"] > 0
        assert ev.path[-2:] == ("dist.round", "exchange")
    rep = reconcile(tracer)
    assert "exchange" in {c.component for c in rep.components}
    assert rep.report.ok


@pytest.mark.parametrize("overlap", [False, True])
def test_phase_steps_run_the_round_make_sharded_step_runs(overlap):
    """``make_phase_steps``'s phases, called one by one on the extended
    blocks, give the round ``make_sharded_step`` gives."""
    from repro_torch.dist import make_phase_steps
    from repro_torch.dist.stencil import _assemble_ext
    spec = SPECS["diag9"][1]
    block = masked_block(lambda e: TS.apply_stencil(e, spec))
    u = grid_from_numpy(_grid(seed=7, ring=True), device="cpu")
    interior, bc = TD.split_ringed_bands(u)
    bc.update(tl=u[:1, :1], tr=u[:1, -1:], bl=u[-1:, :1], br=u[-1:, -1:])
    want = make_sharded_step(_mesh("2x2"), spec, block, row_axis="x",
                             col_axis="y", t=3, overlap=overlap)(interior,
                                                                 bc)
    steps = make_phase_steps(_mesh("2x2"), spec, block, row_axis="x",
                             col_axis="y", t=3)
    shards = [interior[i:i + 16, j:j + 32] for i in (0, 16) for j in (0, 32)]
    state = steps["start"](_assemble_ext(
        shards, *(bc[k] for k in ("top", "bottom", "left", "right", "tl",
                                  "tr", "bl", "br")), px=2, py=2, r=1, d=3))
    if overlap:
        keeps = steps["interior"](state)
        steps["exchange"](state)
        steps["rind"](state, keeps)
    else:
        steps["exchange"](state)
        steps["compute"](state)
    got = [e[3:-3, 3:-3] for e in state.exts]
    assert torch.equal(torch.cat([torch.cat(got[:2], 1),
                                  torch.cat(got[2:], 1)]), want)


def test_depth_check_refuses_a_halo_deeper_than_the_shard():
    spec = TS.jacobi_2d_5pt()
    u = TS.make_laplace_problem(16, 64, device="cpu")
    with pytest.raises(ValueError, match="exceeds local block"):
        TE.run_distributed(u, spec, mesh=_mesh("4"), policy="rowchunk",
                           iters=5, t=5)
    step = make_sharded_step(_mesh("2x2"), spec,
                             masked_block(lambda e: TS.apply_stencil(e, spec)),
                             row_axis="x", col_axis="y", t=9)
    interior, bc = TD.split_ringed_bands(TS.make_laplace_problem(
        16, 64, device="cpu"))
    with pytest.raises(ValueError, match=r"halo depth 9 \(t=9 sweeps"):
        step(interior, bc)


def test_clamped_t_warns_and_remainder_policy_must_be_non_fused():
    mesh = ShardMesh((1,), ("x",), ["cpu"])
    u = TS.make_laplace_problem(16, 32, device="cpu")
    with pytest.warns(UserWarning, match="exceeds iters"):
        got = TE.run_distributed(u, mesh=mesh, policy="rowchunk", iters=2,
                                 t=5)
    assert torch.equal(got, TE.run(u, policy="rowchunk", iters=2))
    with pytest.raises(ValueError, match="non-fused"):
        TE.run_distributed(u, mesh=mesh, policy="temporal", iters=5, t=2,
                           remainder_policy="temporal")


@pytest.mark.parametrize("overlap", [False, True])
def test_single_shard_and_donation(overlap):
    """One shard: nothing to exchange, the split still bit-exact;
    ``donate=True`` writes the result into the caller's grid."""
    u = grid_from_numpy(_grid(16, 32, seed=4), device="cpu")
    want = TE.run(u, policy="rowchunk", iters=6)
    mesh = ShardMesh((1,), ("x",), ["cpu"])
    got = TE.run_distributed(u, mesh=mesh, policy="temporal", iters=6, t=3,
                             overlap=overlap)
    assert torch.equal(got, want) and got.data_ptr() != u.data_ptr()
    v = u.clone()
    got = TE.run_distributed(v, mesh=mesh, policy="temporal", iters=6, t=3,
                             overlap=overlap, donate=True)
    assert got.data_ptr() == v.data_ptr() and torch.equal(v, want)


def test_plan_validates_the_extended_shard_against_the_device():
    u = TS.make_laplace_problem(128, 4096, device="cpu")
    mesh = ShardMesh((1,), ("x",), ["cpu"])
    with pytest.raises(TE.PlanError, match="grayskull_e150"):
        TE.run_distributed(u, mesh=mesh, policy="rowchunk", iters=1,
                           device="grayskull_e150")


@pytest.mark.parametrize("mesh,depth,overlap", [
    (m, dp, ov) for m, dp, ov in itertools.product(
        [((8,), ("data",)), ((4, 2), ("data", "model")),
         ((2, 4), ("data", "model"))], (1, 2, 4), (True, False))])
def test_legacy_halo_front_door(mesh, depth, overlap):
    """``core.halo``'s Jacobi step delegates to the sharded step: bit for
    bit the single-device reference policy (``tests/_halo_check.py``'s
    meshes and depths)."""
    shape, axes = mesh
    tmesh = ShardMesh(shape, axes, ["cpu"] * 8)
    u = grid_from_numpy(_grid(64, 128, seed=2), device="cpu")
    interior, bc = TD.split_ringed(u)
    step = TH.make_distributed_step(tmesh,
                                    col_axis="model" if len(axes) > 1
                                    else None, depth=depth, overlap=overlap)
    got = TH.jacobi_run_distributed(interior, bc, 8, step, depth=depth)
    want = TE.run(u, policy="reference", iters=8)
    assert torch.equal(got, want[1:-1, 1:-1])
    with pytest.raises(ValueError, match="not divisible"):
        TH.jacobi_run_distributed(interior, bc, 7, step, depth=2)


def test_exchange_helpers_hand_each_shard_its_neighbours_edges():
    shards = [torch.full((4, 3), float(i)) for i in range(3)]
    rows = TH.exchange_rows(shards, depth=2)
    assert torch.equal(rows[0][0], torch.zeros(2, 3))
    assert torch.equal(rows[0][1], shards[1][:2])
    assert torch.equal(rows[1][0], shards[0][-2:])
    assert torch.equal(rows[2][1], torch.zeros(2, 3))
    cols = TH.exchange_cols(shards, depth=1)
    assert torch.equal(cols[1][1], shards[2][:, :1])
    assert torch.equal(cols[2][0], shards[1][:, -1:])
    (z0, z1), = TH.exchange_rows(shards[:1], depth=1)
    assert not z0.any() and not z1.any()


@pytest.mark.parametrize("r", [1, 2])
def test_decomp_equals_the_reference(r):
    a = _grid(12, 20, seed=6, ring=True)
    a = np.pad(a, r - 1, constant_values=0.5)
    u = torch.from_numpy(a)
    ti, tbc = TD.split_ringed_bands(u, r)
    ji, jbc = JD.split_ringed_bands(jnp.asarray(a), r)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    for k in jbc:
        assert np.array_equal(tbc[k].numpy(), np.asarray(jbc[k]))
    assert np.array_equal(
        TD.join_ringed_bands(ti, tbc, r, corner=0.25).numpy(),
        np.asarray(JD.join_ringed_bands(ji, jbc, r, corner=0.25)))
    if r == 1:
        ti, tbc = TD.split_ringed(u)
        ji, jbc = JD.split_ringed(jnp.asarray(a))
        assert np.array_equal(TD.join_ringed(ti, tbc).numpy(),
                              np.asarray(JD.join_ringed(ji, jbc)))
    TD.check_divisible(12, 20, 4, 2)
    with pytest.raises(ValueError, match="not divisible"):
        TD.check_divisible(12, 20, 5, 2)


def test_shard_mesh_maps_shards_to_devices():
    mesh = ShardMesh((2, 3), ("x", "y"), [f"cpu:{i}" for i in range(6)])
    assert mesh.shape == {"x": 2, "y": 3} and mesh.axis_names == ("x", "y")
    assert len(mesh.devices) == 6
    assert mesh.device(x=1, y=2) == torch.device("cpu:5")
    assert mesh.device(x=1) == torch.device("cpu:3")
    with pytest.raises(IndexError):
        mesh.device(x=2)
    with pytest.raises(ValueError, match="6 shards"):
        ShardMesh((2, 3), ("x", "y"), ["cpu"])
    with pytest.raises(ValueError, match="one name an axis"):
        ShardMesh((2, 3), ("x",), ["cpu"] * 6)


def test_shard_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh lands on it")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardMesh((4,), ("x",))


def test_cli_distributed_on_cpu_checks_against_single_device():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--devices", "4",
         "--depth", "8", "--device", "cpu", "--check", "--ny", "64",
         "--nx", "128", "--iters", "19"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert ("temporal: 19 sweeps = 2 x t=8 + 3 (rowchunk); 3 exchanges "
            "(halo depth 8)" in res.stdout)
    assert "exchange bill:" in res.stdout
    assert "bit for bit" in res.stdout and "CHECK OK" in res.stdout
