"""The port's backends (Tensix IR, lowering, functional simulator) against
``repro.backends``, on the CPU at the reference tests' sizes.

Twin of ``tests/test_backends.py``: the same numpy inputs go through both
packages. Lowered programs print the same ``describe()`` text; simulated
grids are equal bit for bit (f32 row-major and bf16 tilized); the
counters are equal; the modeled times and mesh exchange bills agree to a
relative 1e-12; and the CB overflow/underflow and masked-program
refusals raise the same errors. Where the reference holds its simulator
against its ``engine.run``, the port's is held against the port's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as JB
from repro import engine as JE
from repro.backends import ir as JIR
from repro.backends import report as JR
from repro.core import stencil as JS
from repro.engine.device import GRAYSKULL_E150 as J_E150
from repro_torch import backends as TB
from repro_torch import engine as TE
from repro_torch.backends import ir as TIR
from repro_torch.backends import report as TR
from repro_torch.backends.lower import LoweringError
from repro_torch.core import stencil as TS
from repro_torch.engine.device import get_device as t_get_device

REL = 1e-12
DIAG9 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))
ROW3 = ((0, -1), (0, 0), (0, 1))
SPECS = {
    "jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
    "diag9": (JS.StencilSpec(DIAG9, (0.125,) * 8),
              TS.StencilSpec(DIAG9, (0.125,) * 8)),
    "row3": (JS.StencilSpec(ROW3, (0.25, 0.5, 0.25)),
             TS.StencilSpec(ROW3, (0.25, 0.5, 0.25))),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _problem(ny=32, nx=64, dtype="float32") -> np.ndarray:
    """The reference tests' grid (ring: left 1, right 0; interior bumps)
    as f32 numpy, exact in bf16."""
    u = np.zeros((ny + 2, nx + 2), np.float32)
    u[:, 0] = 1.0
    u[0, :] = u[-1, :] = 0.0
    u[1:-1, 1:-1] = (np.arange(ny * nx, dtype=np.float32)
                     .reshape(ny, nx) % 7) / 8
    return u


def _j(a: np.ndarray, dtype="float32"):
    return jnp.asarray(a).astype(JDT[dtype])


def _t(a: np.ndarray, dtype="float32") -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])


def _np(grid) -> np.ndarray:
    if isinstance(grid, torch.Tensor):
        return grid.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(grid).astype(jnp.float32))


def _rel(a: float, b: float) -> None:
    assert a == pytest.approx(b, rel=REL, abs=0.0)


def _counters(tc, jc) -> None:
    t, j = tc.as_dict(), jc.as_dict()
    for k in ("reader", "compute", "writer"):
        secs_t, secs_j = t[k].pop("seconds"), j[k].pop("seconds")
        _rel(secs_t, secs_j)
    assert t == j


def _bill(tb, jb) -> None:
    assert (tb is None) == (jb is None)
    if tb is None:
        return
    for f in dataclasses.fields(jb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        if isinstance(b, float):
            _rel(a, b)
        else:
            assert a == b, f.name


def _same(tres, jres) -> None:
    """Everything a SimResult carries, port against reference."""
    np.testing.assert_array_equal(_np(tres.grid), _np(jres.grid))
    assert tres.grid.dtype == TDT[str(jnp.asarray(jres.grid).dtype)]
    _counters(tres.counters, jres.counters)
    _rel(tres.model_time_s, jres.model_time_s)
    assert tres.cores_used == jres.cores_used
    assert tres.device.name == jres.device.name
    assert [p.describe() for p in tres.programs] == [
        p.describe() for p in jres.programs]
    assert tres.interior_points == jres.interior_points
    _bill(tres.exchange_model, jres.exchange_model)


def _simulate(u: np.ndarray, spec_name="jacobi5", dtype="float32",
              mask=None, **kw):
    """One simulation in each package from the same numpy grid."""
    js, ts = SPECS[spec_name]
    jres = JB.simulate(_j(u, dtype), js, mask=mask, **kw)
    tres = TB.simulate(_t(u, dtype), ts, mask=mask, **kw)
    _same(tres, jres)
    return tres, jres


# ---------------------------------------------------------------------------
# tilize / untilize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 32), (64, 96), (33, 65), (5, 130)])
def test_tilize_untilize_roundtrip_bf16(shape):
    a = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ja = a.astype(JIR.np_dtype("bfloat16"))
    ta = _t(a, "bfloat16")
    jt, tt = JIR.tilize(ja, 32, 32), TIR.tilize(ta, 32, 32)
    assert tuple(tt.shape) == jt.shape
    assert tuple(tt.shape[:2]) == TIR.tile_grid(*shape, 32, 32)
    np.testing.assert_array_equal(_np(tt), jt.astype(np.float32))
    back = TIR.untilize(tt, *shape)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(back), _np(ta))


def test_tilize_pads_ragged_edges_with_zeros():
    a = np.ones((33, 40), np.float32)
    tiles = TIR.tilize(_t(a), 32, 32)
    assert tuple(tiles.shape[:2]) == (2, 2)
    assert float(tiles[1, 0, 1:, :].sum()) == 0.0
    np.testing.assert_array_equal(_np(tiles), JIR.tilize(a, 32, 32))


def test_tilize_casts_to_bf16_lossy_for_f32():
    a = np.full((32, 32), 1.0 + 2**-10, np.float32)
    tiles = TIR.tilize(_t(a), 32, 32, dtype="bfloat16")
    back = TIR.untilize(tiles, 32, 32, dtype="float32")
    assert bool((back != _t(a)).all())
    want = JIR.untilize(JIR.tilize(a, 32, 32,
                                   dtype=JIR.np_dtype("bfloat16")),
                        32, 32, dtype=np.float32)
    np.testing.assert_array_equal(_np(back), want)


# ---------------------------------------------------------------------------
# CB bookkeeping: overflow / underflow
# ---------------------------------------------------------------------------

def _tiny_program(pkg, cb_tiles: int, with_producer: bool = True):
    """A hand-built one-block program with an undersized / unfed CB, in
    either package (``pkg`` is ``"jax"`` or ``"torch"``)."""
    if pkg == "jax":
        ir, dev = JIR, J_E150
        spec = JS.jacobi_2d_5pt()
        plan = JE.plan_for((34, 66), jnp.float32, spec, "rowchunk", bm=32,
                           device=dev)
    else:
        ir, dev = TIR, t_get_device("grayskull_e150")
        spec = TS.jacobi_2d_5pt()
        plan = TE.plan_for((34, 66), torch.float32, spec, "rowchunk",
                           bm=32, device=dev)
    cbs = (ir.CircularBuffer("in", cb_tiles, dev.tile_rows, dev.tile_cols,
                             "float32"),
           ir.CircularBuffer("out", 64, dev.tile_rows, dev.tile_cols,
                             "float32"))
    reader = (ir.ReadBlock(cb="in", dy=-1, rows=34, col0=0, cols=66),) \
        if with_producer else ()
    return ir.TensixProgram(
        policy="rowchunk", spec=spec, plan=plan, cbs=cbs, reader=reader,
        compute=(ir.TapReduce(src="in", dst="out", row_off=1, col_off=1,
                              out_rows=32, out_cols=64),),
        writer=(ir.WriteBlock(cb="out", dy=0, rows=32, col0=1, cols=64,
                              contiguous=False),))


def _same_error(jfn, tfn, jexc, texc, match: str | None) -> None:
    with pytest.raises(jexc, match=match) as je:
        jfn()
    with pytest.raises(texc, match=match) as te:
        tfn()
    assert str(te.value) == str(je.value)


def test_cb_overflow_detected_at_push():
    u = np.zeros((34, 66), np.float32)
    jp, tp = _tiny_program("jax", 2), _tiny_program("torch", 2)
    assert tp.describe() == jp.describe()
    _same_error(lambda: JB.simulate_program(u, jp),
                lambda: TB.simulate_program(_t(u), tp),
                JIR.CBOverflowError, TIR.CBOverflowError, "overflow")


def test_cb_underflow_detected_statically_and_at_pop():
    u = np.zeros((34, 66), np.float32)
    jp = _tiny_program("jax", 64, with_producer=False)
    tp = _tiny_program("torch", 64, with_producer=False)
    _same_error(jp.validate, tp.validate, JIR.CBUnderflowError,
                TIR.CBUnderflowError, "underflow|pops")
    _same_error(lambda: JB.simulate_program(u, jp),
                lambda: TB.simulate_program(_t(u), tp),
                JIR.CBUnderflowError, TIR.CBUnderflowError, None)


def test_program_rejects_undeclared_cb():
    progs = []
    for pkg, ir in (("jax", JIR), ("torch", TIR)):
        prog = _tiny_program(pkg, 64)
        progs.append(dataclasses.replace(
            prog, writer=(ir.WriteBlock(cb="nope", dy=0, rows=32, col0=1,
                                        cols=64),)))
    _same_error(progs[0].validate, progs[1].validate, JIR.BackendError,
                TIR.BackendError, "undeclared")


# ---------------------------------------------------------------------------
# Lowering: device budgets bind a second time
# ---------------------------------------------------------------------------

def test_lowering_validates_cb_count():
    from repro.backends.lower import LoweringError as JLoweringError
    from repro.backends.lower import lower as jlower
    jt = dataclasses.replace(J_E150, name="cb_poor", cb_count=3)
    tt = dataclasses.replace(t_get_device("grayskull_e150"), name="cb_poor",
                             cb_count=3)
    _same_error(
        lambda: jlower((34, 66), jnp.float32, JS.jacobi_2d_5pt(), "shifted",
                       device=jt),
        lambda: TB.lower((34, 66), torch.float32, TS.jacobi_2d_5pt(),
                         "shifted", device=tt),
        JLoweringError, LoweringError, "circular buffers")


def test_lowering_validates_sram_budget():
    from repro.backends.lower import LoweringError as JLoweringError
    from repro.backends.lower import lower as jlower
    jt = dataclasses.replace(J_E150, name="sram_poor",
                             fast_memory_bytes=96 * 1024)
    tt = dataclasses.replace(t_get_device("grayskull_e150"),
                             name="sram_poor", fast_memory_bytes=96 * 1024)
    _same_error(
        lambda: jlower((130, 258), jnp.float32, JS.jacobi_2d_5pt(), "dbuf",
                       bm=64, device=jt, tilized=True),
        lambda: TB.lower((130, 258), torch.float32, TS.jacobi_2d_5pt(),
                         "dbuf", bm=64, device=tt, tilized=True),
        (JLoweringError, JE.PlanError), (LoweringError, TE.PlanError),
        None)


@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal"])
@pytest.mark.parametrize("tilized", [None, False, True])
def test_lowered_programs_fit_declared_budget(policy, tilized):
    from repro.backends.lower import lower as jlower
    jp = jlower((34, 66), jnp.float32, JS.jacobi_2d_5pt(), policy, t=2,
                device="grayskull_e150", tilized=tilized)
    tp = TB.lower((34, 66), torch.float32, TS.jacobi_2d_5pt(), policy, t=2,
                  device="grayskull_e150", tilized=tilized)
    assert tp.sram_bytes <= tp.plan.device.fast_memory_bytes
    assert len(tp.cbs) <= tp.plan.device.cb_count
    tp.validate()
    assert tp.describe() == jp.describe()
    assert (tp.sram_bytes, tp.double_buffered, tp.tilized) == (
        jp.sram_bytes, jp.double_buffered, jp.tilized)


def test_dbuf_is_double_buffered_rowchunk_is_not():
    db = TB.lower((34, 66), torch.float32, TS.jacobi_2d_5pt(), "dbuf",
                  device="grayskull_e150")
    rc = TB.lower((34, 66), torch.float32, TS.jacobi_2d_5pt(), "rowchunk",
                  device="grayskull_e150")
    assert db.double_buffered and not rc.double_buffered


# ---------------------------------------------------------------------------
# Simulator == the reference's simulator == the port's engine.run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("t", [1, 3])
def test_sim_matches_engine_run_fp32_exact(policy, spec_name, t):
    u = _problem()
    iters = 4  # t=3 exercises the fused + remainder schedule
    tres, _ = _simulate(u, spec_name, policy=policy, iters=iters, t=t,
                        device="grayskull_e150")
    want = TE.run(_t(u), SPECS[spec_name][1], policy=policy, iters=iters,
                  t=t, device="cpu_ref")
    assert torch.equal(tres.grid, want)
    assert tres.counters.sweeps == iters
    assert tres.model_time_s > 0


@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal"])
def test_sim_matches_engine_run_bf16_tilized_exact(policy):
    u = _problem()
    tres, _ = _simulate(u, dtype="bfloat16", policy=policy, iters=3, t=3,
                        device="grayskull_e150")
    assert tres.programs[0].tilized
    want = TE.run(_t(u, "bfloat16"), TS.jacobi_2d_5pt(), policy=policy,
                  iters=3, t=3, device="cpu_ref")
    assert torch.equal(tres.grid, want)


def test_masked_temporal_lowering_streams_the_pin_mask():
    from repro.backends.lower import lower as jlower
    prog = TB.lower((34, 66), torch.float32, TS.jacobi_2d_5pt(), "temporal",
                    t=2, masked=True, device="grayskull_e150")
    mask_reads = [op for op in prog.reader
                  if isinstance(op, TIR.ReadBlock) and op.src == "mask"]
    assert len(mask_reads) == 1 and mask_reads[0].cb == "mask"
    sweeps = [op for op in prog.compute if isinstance(op, TIR.LocalSweeps)]
    assert sweeps[0].mask == "mask"
    assert prog.plan.masked
    assert prog.describe() == jlower(
        (34, 66), jnp.float32, JS.jacobi_2d_5pt(), "temporal", t=2,
        masked=True, device="grayskull_e150").describe()
    plain = TB.lower((34, 66), torch.float32, TS.jacobi_2d_5pt(),
                     "temporal", t=2, device="grayskull_e150")
    assert all(op.src == "grid" for op in plain.reader
               if isinstance(op, TIR.ReadBlock))


@pytest.mark.parametrize("device", ["grayskull_e150", "cpu_ref"])
def test_sim_masked_temporal_matches_engine_masked_kernel(device):
    t, d = 2, 2
    u = _problem()
    h, w = u.shape
    mask = np.zeros((h, w), bool)
    mask[:d, :] = mask[:, :d] = True
    tres, _ = _simulate(u, mask=mask, policy="temporal", iters=t, t=t,
                        device=device)
    want = TE.stencil_temporal(_t(u), TS.jacobi_2d_5pt(), t=t,
                               mask=torch.from_numpy(mask))
    got = tres.grid
    assert torch.equal(got[:h - d, :w - d], want[:h - d, :w - d])
    assert torch.equal(got[torch.from_numpy(mask)],
                       _t(u)[torch.from_numpy(mask)])
    plain, _ = _simulate(u, policy="temporal", iters=t, t=t, device=device)
    assert tres.counters.reader.bytes > plain.counters.reader.bytes


def test_sim_masked_program_requires_the_mask_stream():
    from repro.backends.lower import lower as jlower
    from repro.backends.sim import run_program as jrun_program
    jp = jlower((34, 66), jnp.float32, JS.jacobi_2d_5pt(), "temporal", t=2,
                masked=True, device="grayskull_e150")
    tp = TB.lower((34, 66), torch.float32, TS.jacobi_2d_5pt(), "temporal",
                  t=2, masked=True, device="grayskull_e150")
    _same_error(lambda: jrun_program(np.zeros((34, 66), np.float32), jp),
                lambda: TB.sim.run_program(torch.zeros((34, 66)), tp),
                JIR.BackendError, TIR.BackendError, "mask")


@pytest.mark.parametrize("policy,iters", [("temporal", 3), ("rowchunk", 2)])
def test_sim_mask_rejects_unfused_and_remainder_schedules(policy, iters):
    u = _problem()
    mask = np.zeros(u.shape, bool)
    mask[:2, :] = mask[:, :2] = True
    kw = dict(policy=policy, iters=iters, t=2, mask=mask,
              device="grayskull_e150")
    _same_error(lambda: JB.simulate(_j(u), JS.jacobi_2d_5pt(), **kw),
                lambda: TB.simulate(_t(u), TS.jacobi_2d_5pt(), **kw),
                JIR.BackendError, TIR.BackendError, "fully-fused")


def test_sim_f32_through_tiles_is_bf16_tolerant():
    u = _problem()
    tres, _ = _simulate(u, policy="rowchunk", iters=5,
                        device="grayskull_e150", tilized=True)
    want = TE.run(_t(u), TS.jacobi_2d_5pt(), policy="rowchunk", iters=5,
                  device="cpu_ref")
    assert not torch.equal(tres.grid, want)  # quantization really happened
    torch.testing.assert_close(tres.grid, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("policy", ["rowchunk", "temporal"])
def test_sim_iters_zero_returns_grid_unchanged(policy):
    u = _problem()
    tres, _ = _simulate(u, policy=policy, iters=0, device="cpu_ref")
    assert torch.equal(tres.grid, _t(u))
    assert tres.counters.sweeps == 0 and tres.model_time_s == 0.0


def test_cb_queue_is_fifo_under_multiple_pushes():
    from repro_torch.backends import sim
    prog = _tiny_program("torch", 64)
    cbs = sim._CBState(prog)
    dev = prog.plan.device
    a = sim._block_entry(torch.zeros((32, 32)), dev)
    b = sim._block_entry(torch.ones((32, 32)), dev)
    cbs.push("in", a)
    cbs.push("in", b)
    assert cbs.occ["in"] == a["tiles"] + b["tiles"]
    assert cbs.pop("in") is a
    assert cbs.pop("in") is b
    assert cbs.occ["in"] == 0
    with pytest.raises(TIR.CBUnderflowError):
        cbs.pop("in")


@pytest.mark.parametrize("device", ["cpu_ref", "grayskull_e150", "tpu_v5e"])
def test_sim_auto_policy_resolves_like_engine(device):
    u = _problem()
    tres, _ = _simulate(u, policy="auto", iters=6, device=device)
    want = TE.run(_t(u), TS.jacobi_2d_5pt(), policy="auto", iters=6,
                  device=device)
    assert torch.equal(tres.grid, want)


# ---------------------------------------------------------------------------
# Counters / step model: the paper's ordering falls out
# ---------------------------------------------------------------------------

def test_counter_traffic_reproduces_policy_ordering():
    u = _problem()
    bpp = {}
    for policy in TB.lowerable_policies():
        tres, jres = _simulate(u, policy=policy, iters=4, t=4,
                               device="grayskull_e150")
        bpp[policy] = TR.bytes_per_point(tres)
        for kind in ("dram", "read", "write"):
            assert TR.bytes_per_point(tres, kind) == JR.bytes_per_point(
                jres, kind)
        s, r = TR.summarize(tres), JR.summarize(jres)
        assert s.keys() == r.keys()
        for k in s:
            assert s[k] == pytest.approx(r[k], rel=REL, abs=0.0), k
    assert bpp["shifted"] > 2 * bpp["rowchunk"]
    assert bpp["dbuf"] == bpp["rowchunk"]
    assert bpp["temporal"] < bpp["rowchunk"] / 1.5


def test_double_buffering_overlaps_the_pipeline():
    u = _problem(64, 128)
    kw = dict(iters=2, device="grayskull_e150", bm=16)
    t_rc = _simulate(u, policy="rowchunk", **kw)[0].model_time_s
    t_db = _simulate(u, policy="dbuf", **kw)[0].model_time_s
    assert t_db < t_rc


def test_copy_model_matches_paper_access_sweep_shape():
    dev = "grayskull_e150"
    cases = {"base": dict(seg_cols=4096), "small": dict(seg_cols=1),
             "sync": dict(seg_cols=1, sync=True),
             "repl": dict(seg_cols=4096, reads=32),
             "il": dict(seg_cols=4096, reads=32, interleaved=True)}
    s = {}
    for name, kw in cases.items():
        s[name] = TR.model_copy_seconds((4096, 4096), "int32", device=dev,
                                        torch_device="cpu", **kw)
        _rel(s[name], JR.model_copy_seconds((4096, 4096), "int32",
                                            device=dev, **kw))
    assert 100 < s["small"] / s["base"] < 250          # paper: 160x
    assert 5 < s["sync"] / s["small"] < 10             # paper: 7.2x
    assert 14 < s["repl"] / s["base"] < 20             # paper: 16.8x
    assert 1.8 < s["repl"] / s["il"] < 2.3             # paper: 2.05x
    assert abs(s["base"] - 0.011) / 0.011 < 0.1        # paper: 0.011 s


def test_copy_model_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TR.model_copy_seconds((64, 64), "int32", device="grayskull_e150")


def test_simulate_program_and_summarize_shapes():
    from repro.backends.lower import make_copy_program as jmake
    tp = TB.make_copy_program((64, 128), "float32", bm=16,
                              device="grayskull_e150")
    jp = jmake((64, 128), "float32", bm=16, device="grayskull_e150")
    assert tp.describe() == jp.describe()
    ones = np.ones((64, 128), np.float32)
    tres = TB.simulate_program(_t(ones), tp)
    _same(tres, JB.simulate_program(ones, jp))
    assert torch.equal(tres.grid, _t(ones))
    s = TR.summarize(tres)
    assert s["policy"] == "copy" and s["dram_bytes"] == 2 * 64 * 128 * 4
    assert set(s) >= {"gpts", "energy_j", "model_time_s", "bytes_per_point"}


@pytest.mark.parametrize("device", ["grayskull_e150", "tpu_v5e"])
def test_tile_efficiency_penalizes_misalignment(device):
    full = TR.tile_efficiency(512, 512, device=device)
    ragged = TR.tile_efficiency(512, 514, device=device)
    assert full == 1.0 and ragged < 0.95
    assert ragged == JR.tile_efficiency(512, 514, device=device)


# ---------------------------------------------------------------------------
# The port's own rule: a 2-D tile plan lowers only as a row-block plan
# ---------------------------------------------------------------------------

def test_gpu_tile_plans_lower_as_row_blocks_or_raise():
    spec = TS.jacobi_2d_5pt()
    # K1's compiled 5-point tile is 40 x 112: narrower than the interior.
    with pytest.raises(LoweringError, match="row-blocked"):
        TB.lower((66, 130), torch.float32, spec, "temporal", t=2,
                 device="gpu_sm90")
    # A full-width tile whose bm divides the interior lowers as the
    # row-block plan of that bm, equal to the row-block lowering.
    prog = TB.lower((66, 130), torch.float32, spec, "rowchunk", bm=8,
                    device="gpu_sm90")
    assert (prog.plan.bm, prog.plan.bn, prog.plan.window_rows,
            prog.plan.nblocks) == (8, 128, 10, 8)
    read = prog.reader[0]
    assert (read.dy, read.rows, read.col0, read.cols) == (-1, 10, 0, 130)
    sim = TB.simulate(_t(_problem(64, 128)), spec, policy="rowchunk",
                      iters=3, bm=8, device="gpu_sm90")
    assert torch.equal(sim.grid, TE.run(_t(_problem(64, 128)), spec,
                                        policy="rowchunk", iters=3,
                                        device="cpu_ref"))
    with pytest.raises(LoweringError, match="row-blocked"):
        TB.lower((66, 130), torch.float32, spec, "rowchunk", bm=24,
                 device="gpu_sm90")


# ---------------------------------------------------------------------------
# Mesh step model: exchange hidden behind the interior, priced by the sim
# ---------------------------------------------------------------------------

def test_sim_mesh_exchange_model_overlap_wins_when_exchange_bound():
    u = np.zeros((66, 2042), np.float32)
    u[:, 0] = 1.0
    kw = dict(policy="rowchunk", iters=2, bm=16, device="grayskull_e150")
    base, _ = _simulate(u, **kw)
    ser, _ = _simulate(u, mesh_shape=(8,), **kw)
    ovl, _ = _simulate(u, mesh_shape=(8,), overlap=True, **kw)
    assert base.exchange_model is None
    bill = ovl.exchange_model
    assert bill is not None and bill.feasible and bill.wins
    assert ovl.model_time_s < ser.model_time_s
    assert ser.model_time_s == bill.serial_s
    assert ovl.model_time_s == bill.overlapped_s
    assert bill.exchange_s > bill.interior_s
    assert torch.equal(ovl.grid, ser.grid) and torch.equal(ovl.grid,
                                                           base.grid)


@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal"])
@pytest.mark.parametrize("overlap", [False, True])
def test_sim_mesh_bill_per_policy(policy, overlap):
    _simulate(_problem(), policy=policy, iters=5, t=2, mesh_shape=(8,),
              overlap=overlap, device="grayskull_e150")


def test_sim_mesh_rejects_undecomposable_grid():
    u = np.zeros((32, 68), np.float32)
    kw = dict(policy="rowchunk", iters=1, mesh_shape=(4,),
              device="grayskull_e150")
    _same_error(lambda: JB.simulate(_j(u), **kw),
                lambda: TB.simulate(_t(u), **kw),
                JB.BackendError, TB.BackendError, "does not decompose")


# ---------------------------------------------------------------------------
# Every lowerable policy x spec, masked and meshed, on the e150 model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sim_policy_spec_matrix(spec_name, dtype):
    u = _problem()
    for policy in TB.lowerable_policies():
        _simulate(u, spec_name, dtype, policy=policy, iters=7, t=3,
                  device="grayskull_e150")
        _simulate(u, spec_name, dtype, policy=policy, iters=6, t=3,
                  device="grayskull_e150", interleaved=True)
    r = SPECS[spec_name][0].radius
    mask = np.zeros(u.shape, bool)
    mask[:2 * 3 * r, :] = mask[:, :2 * 3 * r] = True
    _simulate(u, spec_name, dtype, mask=mask, policy="temporal", iters=6,
              t=3, device="grayskull_e150", mesh_shape=(8,), overlap=True)


def test_smoke_runs_on_the_cpu(capsys):
    from repro_torch.backends.sim import _smoke
    assert _smoke("grayskull_e150", "cpu") == 0
    assert "BACKENDS SMOKE OK" in capsys.readouterr().out
