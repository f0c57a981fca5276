"""The port's distributed schedule and exchange bill against the JAX package's.

``build_schedule(exchange_cadence=True)``, ``price_exchange`` and
``ExchangeBill`` equal the reference's field for field (the same float
arithmetic on the same device constants), on the cases of
``tests/test_schedule.py``'s overlap section and a grid of meshes, depths
and policies; ``overlap=None`` resolves by the same price;
``plan_distributed`` gives the reference's schedule and extended shard for
the same mesh shape (the reference's planner reads only a mesh's
``shape`` and ``axis_names``, so a stand-in mesh plans it without
devices).
"""
import dataclasses
import types
import warnings

import jax.numpy as jnp
import pytest
import torch

from repro import engine as JE
from repro.core import stencil as JS
from repro.engine.plan import PlanError as JPlanError
from repro_torch import engine as TE
from repro_torch.core import stencil as TS
from repro_torch.dist import ShardMesh
from repro_torch.engine.plan import PlanError as TPlanError

SPECS = {"jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
         "laplace9": (JS.laplace_2d_9pt(), TS.laplace_2d_9pt())}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sched_both(iters, spec="jacobi5", dtype="float32", **kw):
    js, ts = SPECS[spec]
    jd, td = DTYPES[dtype]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JE.build_schedule(iters, spec=js, dtype=jd, **kw),
                TE.build_schedule(iters, spec=ts, dtype=td,
                                  torch_device="cpu", **kw))


# The overlap cases of tests/test_schedule.py: (iters, shard, policy, t,
# device, mesh), each with its expected verdict.
BILL_CASES = {
    "e150_overlap_wins": (2, (130, 2042), "rowchunk", 1, "grayskull_e150",
                          (8,), True),
    "host_serial_wins": (3, (14, 70), "rowchunk", 3, "cpu_ref", (4,),
                         False),
    "infeasible": (4, (16, 72), "temporal", 4, "cpu_ref", (4,), False),
    "gpu_sm90_paper_grid": (1003, (272, 9232), "temporal", 8, "gpu_sm90",
                            (4,), None),
    "gpu_sm90_2x2": (1003, (528, 4624), "temporal", 8, "gpu_sm90", (2, 2),
                     None),
    "tpu_2x2_remainder": (7, (22, 38), "temporal", 3, "tpu_v5e", (2, 2),
                          None),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(BILL_CASES))
def test_price_exchange_equals_reference(case, dtype):
    iters, shard, policy, t, device, mesh, wins = BILL_CASES[case]
    scheds = _sched_both(iters, dtype=dtype, shape=shard, policy=policy,
                         t=t, device=device, exchange_cadence=True)
    assert dataclasses.asdict(scheds[0]) == dataclasses.asdict(scheds[1])
    jb = JE.price_exchange(scheds[0], shard_shape=shard,
                           dtype=DTYPES[dtype][0],
                           spec=SPECS["jacobi5"][0], device=device,
                           mesh_shape=mesh)
    tb = TE.price_exchange(scheds[1], shard_shape=shard,
                           dtype=DTYPES[dtype][1],
                           spec=SPECS["jacobi5"][1], device=device,
                           mesh_shape=mesh)
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    assert (tb.wins, tb.describe(), tb.as_attrs()) == (
        jb.wins, jb.describe(), jb.as_attrs())
    if wins is not None:
        assert tb.wins is wins
    # The bill's own arithmetic: serial is the unhidden sum; overlapped
    # hides the exchange under the interior and pays the rind after.
    assert tb.serial_s == pytest.approx(tb.exchange_s + tb.compute_s)
    if not tb.feasible:
        assert tb.overlapped_s == tb.serial_s
    elif not scheds[1].remainder:
        assert tb.overlapped_s == pytest.approx(
            max(tb.exchange_s, tb.interior_s) + tb.rind_s)


def test_price_exchange_takes_a_dtype_name():
    sched = TE.build_schedule(16, spec=TS.jacobi_2d_5pt(), shape=(40, 80),
                              dtype=torch.float32, policy="temporal", t=8,
                              exchange_cadence=True, torch_device="cpu")
    kw = dict(shard_shape=(40, 80), spec=TS.jacobi_2d_5pt(),
              mesh_shape=(2, 2))
    a = TE.price_exchange(sched, dtype=torch.bfloat16, **kw)
    b = TE.price_exchange(sched, dtype="bfloat16", **kw)
    f = TE.price_exchange(sched, dtype="float32", **kw)
    j = JE.price_exchange(
        JE.build_schedule(16, spec=JS.jacobi_2d_5pt(), shape=(40, 80),
                          dtype=jnp.float32, policy="temporal", t=8,
                          exchange_cadence=True),
        dtype=jnp.bfloat16, shard_shape=(40, 80), spec=JS.jacobi_2d_5pt(),
        mesh_shape=(2, 2))
    assert a == b
    assert dataclasses.asdict(a) == dataclasses.asdict(j)
    assert 2 * a.halo_bytes == f.halo_bytes


@pytest.mark.parametrize("device", ["grayskull_e150", "cpu_ref",
                                    "gpu_sm90", "tpu_v5e"])
@pytest.mark.parametrize("shard,mesh", [((130, 2042), (8,)),
                                        ((14, 70), (4,)),
                                        ((528, 4624), (2, 2))])
def test_overlap_none_resolves_by_the_reference_price(device, shard, mesh):
    for iters, t in [(2, 1), (3, 3), (1003, 8), (7, 3)]:
        j, t_ = _sched_both(iters, shape=shard, policy="rowchunk", t=t,
                            device=device, mesh_shape=mesh,
                            exchange_cadence=True)
        assert dataclasses.asdict(t_) == dataclasses.asdict(j)
        assert t_.describe() == j.describe()


def _call_both(iters, t, policy, overlap):
    out = []
    for pkg, spec, dtype, extra in (
            (JE, SPECS["laplace9"][0], jnp.float32, {}),
            (TE, SPECS["laplace9"][1], torch.float32,
             {"torch_device": "cpu"})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            s = pkg.build_schedule(iters, spec=spec, shape=(38, 70),
                                   dtype=dtype, policy=policy, t=t,
                                   device="cpu_ref", mesh_shape=(2, 2),
                                   exchange_cadence=True, overlap=overlap,
                                   **extra)
        out.append((s, [str(x.message) for x in w]))
    return out


@pytest.mark.parametrize("policy", ["auto", "temporal", "rowchunk", "dbuf",
                                    "shifted", "reference"])
def test_exchange_cadence_schedule_equals_reference(policy):
    """Under exchange_cadence, t groups sweeps for non-fused policies too
    (one exchange a t sweeps), and the clamp warns about exchanges."""
    for iters, t in [(19, 4), (1003, 8), (7, 8), (0, None), (6, 3), (5, 2)]:
        for overlap in (None, False, True):
            (j, jw), (t_, tw) = _call_both(iters, t, policy, overlap)
            assert dataclasses.asdict(t_) == dataclasses.asdict(j)
            assert tw == jw
            assert (t_.exchanges, t_.halo_depth, t_.remainder_halo_depth,
                    t_.describe()) == (j.exchanges, j.halo_depth,
                                       j.remainder_halo_depth, j.describe())


def test_overlap_forced_and_gated():
    on, off = (TE.build_schedule(4, spec=TS.jacobi_2d_5pt(), shape=(34, 66),
                                 dtype=torch.float32, policy="rowchunk",
                                 exchange_cadence=True, overlap=ov,
                                 torch_device="cpu")
               for ov in (True, False))
    assert on.overlap and not off.overlap
    assert "overlapped" in on.describe()
    for pkg, spec, dtype, err, extra in (
            (JE, JS.jacobi_2d_5pt(), jnp.float32, JPlanError, {}),
            (TE, TS.jacobi_2d_5pt(), torch.float32, TPlanError,
             {"torch_device": "cpu"})):
        with pytest.raises(err, match="exchange_cadence"):
            pkg.build_schedule(4, spec=spec, shape=(34, 66), dtype=dtype,
                               policy="rowchunk", overlap=True, **extra)


def test_fused_remainder_policy_is_refused_under_exchange_cadence():
    for pkg, spec, dtype, extra in (
            (JE, JS.jacobi_2d_5pt(), jnp.float32, {}),
            (TE, TS.jacobi_2d_5pt(), torch.float32,
             {"torch_device": "cpu"})):
        with pytest.raises(ValueError, match="non-fused"):
            pkg.build_schedule(5, spec=spec, shape=(34, 66), dtype=dtype,
                               policy="temporal", t=2,
                               remainder_policy="temporal",
                               exchange_cadence=True, **extra)


def _stand_in(shape, names):
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


@pytest.mark.parametrize("policy", ["temporal", "rowchunk", "auto",
                                    "reference"])
@pytest.mark.parametrize("mesh", [((4,), ("x",)), ((2, 2), ("x", "y")),
                                  ((1,), ("x",)), ((2, 4), ("a", "b"))])
def test_plan_distributed_equals_reference(mesh, policy):
    shape, names = mesh
    # A shard a device, as on the reference's mesh (planning only: no
    # tensor is placed on these devices).
    tmesh = ShardMesh(shape, names, [torch.device("cpu", i) for i in range(
        shape[0] * (shape[1] if len(shape) > 1 else 1))])
    for iters, t, overlap in [(6, 3, None), (6, 2, True), (7, 3, False),
                              (1003, 8, None)]:
        kw = dict(policy=policy, iters=iters, t=t, device="cpu_ref",
                  overlap=overlap)
        j = JE.plan_distributed((34, 66), jnp.float32, JS.jacobi_2d_5pt(),
                                mesh=_stand_in(shape, names), **kw)
        got = TE.plan_distributed((34, 66), torch.float32,
                                  TS.jacobi_2d_5pt(), mesh=tmesh, **kw)
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(j[0])
        assert got[1:] == j[1:]
        nfull, rem = divmod(iters, got[0].t)
        if got[0].fused:
            assert got[0].exchanges == nfull + (1 if rem else 0)


@pytest.mark.parametrize("mesh", [((4,), ("x",)), ((2, 2), ("x", "y"))])
def test_overlap_none_is_serial_when_the_shards_share_a_device(mesh):
    """At the paper's grid on gpu_sm90 the bill says the overlap wins (a
    device and a link a shard); with every shard on one device nothing
    crosses a link, so plan_distributed resolves overlap=None to the
    serial round. A forced overlap still runs."""
    shape, names = mesh
    kw = dict(policy="temporal", iters=1003, t=8, device="gpu_sm90",
              torch_device="cpu")
    spread = ShardMesh(shape, names, [torch.device("cpu", i)
                                      for i in range(4)])
    shared = ShardMesh(shape, names, ["cpu"] * 4)
    args = ((1026, 9218), torch.bfloat16, TS.jacobi_2d_5pt())
    priced, shard, _ = TE.plan_distributed(*args, mesh=spread, **kw)
    assert priced.overlap
    assert TE.price_exchange(priced, shard_shape=shard, dtype="bfloat16",
                             spec=TS.jacobi_2d_5pt(), device="gpu_sm90",
                             mesh_shape=shape).wins
    sched, _, _ = TE.plan_distributed(*args, mesh=shared, **kw)
    assert sched == dataclasses.replace(priced, overlap=False)
    forced, _, _ = TE.plan_distributed(*args, mesh=shared, overlap=True,
                                       **kw)
    assert forced == priced


def test_plan_distributed_exposes_exchange_bill():
    mesh = ShardMesh((1,), ("x",), ["cpu"])
    sched, shard_shape, axes = TE.plan_distributed(
        (34, 66), torch.float32, mesh=mesh, policy="temporal", iters=7, t=3,
        row_axis="x")
    assert sched.policy == "temporal" and sched.fused
    assert (sched.fused_blocks, sched.remainder, sched.exchanges) == (2, 1, 3)
    assert shard_shape == (32 + 2 * 3, 64 + 2 * 3)
    assert axes == ("x", None)


def test_tuned_distributed_keys_carry_mesh_depth_and_overlap(tmp_path,
                                                             monkeypatch):
    """policy="tuned" under the distributed executor is measured for the
    extended shard at the real t, the mesh, masked=True and the overlap
    the schedule chose, and never aliases a single-device cell."""
    import json

    from repro_torch.engine import tune as TT
    path = tmp_path / "tune.json"
    monkeypatch.setenv(TT.CACHE_ENV, str(path))
    TT.clear()
    u = TS.make_laplace_problem(16, 32, device="cpu")
    want = TE.run(u, policy="rowchunk", iters=6)
    mesh = ShardMesh((1,), ("x",), ["cpu"])
    for ov in (False, True):
        got = TE.run_distributed(u, mesh=mesh, policy="tuned", iters=6, t=3,
                                 overlap=ov)
        assert torch.equal(got, want)
    keys = list(json.loads(path.read_text()))
    assert keys and all("mesh=1" in k and "t=3" in k and "masked=True" in k
                        and "torch_device=cpu" in k for k in keys), keys
    assert {k.rsplit("|", 1)[1] for k in keys} == {"overlap=False",
                                                  "overlap=True"}
    TT.clear()
