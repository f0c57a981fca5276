"""The port's static verifier and verify-sweep against ``repro.analysis``.

Twin of the verifier and sweep cases of ``tests/test_analysis.py`` and
``tests/test_analysis_smoke.py``: the same seeded mutants of the same
lowered programs are rejected with the same codes and the same report
text; unmutated lowerings are accepted with the same occupancy bounds;
accepted programs run clean in the port's simulator. Every cell of the
default sweep, and the 540 cells of ``full=True`` on ``tpu_v5e``,
``grayskull_e150`` and ``cpu_ref``, has the reference's outcome, codes
and detail. On ``gpu_sm90`` the port plans 2-D tiles, and the cells that
differ from the reference's are pinned here (ROADMAP Queue 3).
"""
import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analysis as JA
from repro.analysis import sweep as JSW
from repro.backends import ir as JIR
from repro.backends.lower import lower as jlower
from repro.core import stencil as JS
from repro_torch import analysis as TA
from repro_torch import backends as TB
from repro_torch.analysis import sweep as TSW
from repro_torch.analysis.diagnostics import CODES, Diagnostic, Report
from repro_torch.backends import ir as TIR
from repro_torch.backends.lower import LoweringError
from repro_torch.core import stencil as TS
from repro_torch.engine.plan import PlanError

DEV = "grayskull_e150"
SHAPE = (34, 66)
POLICIES = ["shifted", "rowchunk", "dbuf", "temporal"]
SPECS = {"jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
         "laplace9": (JS.laplace_2d_9pt(), TS.laplace_2d_9pt())}


def _progs(policy, *, t=2, tilized=None, spec="jacobi5", shape=SHAPE,
           masked=False):
    js, ts = SPECS[spec]
    return (jlower(shape, jnp.float32, js, policy, t=t, device=DEV,
                   tilized=tilized, masked=masked),
            TB.lower(shape, torch.float32, ts, policy, t=t, device=DEV,
                     tilized=tilized, masked=masked))


def _rows(report):
    return [(d.severity, d.code, d.span, d.message, d.hint)
            for d in report.diagnostics]


def _verify_both(jprog, tprog):
    """Verify each package's program; the findings and text must agree."""
    jr, tr = JA.verify_program(jprog), TA.verify_program(tprog)
    assert _rows(tr) == _rows(jr)
    assert tr.describe() == jr.describe()
    assert tprog.describe() == jprog.describe()
    return tr


def _codes(report) -> set:
    return {d.code for d in report.errors}


# ---------------------------------------------------------------------------
# Mutation corpus: one mutation, applied to either package's program.
# ---------------------------------------------------------------------------

def _push_tiles(prog, op):
    dev = prog.plan.device
    nty, ntx = TIR.tile_grid(op.rows, op.cols, dev.tile_rows, dev.tile_cols)
    return nty * ntx


def _shrink_cb(prog, ir):
    rb = next(op for op in prog.reader if isinstance(op, ir.ReadBlock))
    need = _push_tiles(prog, rb)
    cbs = tuple(dataclasses.replace(cb, capacity_tiles=need - 1)
                if cb.name == rb.cb else cb for cb in prog.cbs)
    return dataclasses.replace(prog, cbs=cbs)


def _drop_push(prog, ir):
    rb = next(op for op in prog.reader if isinstance(op, ir.ReadBlock))
    return dataclasses.replace(
        prog, reader=tuple(op for op in prog.reader if op is not rb))


def _row_offset(prog, ir):
    r = prog.plan.radius

    def shift(ops):
        done, out = False, []
        for op in ops:
            if not done and isinstance(op, (ir.ReadBlock, ir.WriteBlock)) \
                    and not getattr(op, "clamp", False):
                op = dataclasses.replace(op, dy=op.dy - (r + 1))
                done = True
            out.append(op)
        return tuple(out), done

    reader, hit = shift(prog.reader)
    if hit:
        return dataclasses.replace(prog, reader=reader)
    writer, hit = shift(prog.writer)
    assert hit
    return dataclasses.replace(prog, writer=writer)


def _col_offset(prog, ir):
    wb = next(op for op in prog.writer if isinstance(op, ir.WriteBlock))
    return dataclasses.replace(prog, writer=tuple(
        dataclasses.replace(op, col0=-1) if op is wb else op
        for op in prog.writer))


def _extra_pop(prog, ir):
    return dataclasses.replace(prog, writer=prog.writer + (prog.writer[-1],))


MUTATIONS = {
    "shrink-cb": (_shrink_cb, "CB-OVERFLOW"),
    "drop-push": (_drop_push, "CB-UNFED"),
    "row-offset": (_row_offset, "AB-ROW"),
    "col-offset": (_col_offset, "AB-COL"),
    "extra-pop": (_extra_pop, "CB-UNDERFLOW"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
@pytest.mark.parametrize("policy", POLICIES)
def test_mutant_rejected_with_stable_code(policy, mutation):
    mutate, code = MUTATIONS[mutation]
    jprog, tprog = _progs(policy)
    report = _verify_both(mutate(jprog, JIR), mutate(tprog, TIR))
    assert not report.ok
    assert code in _codes(report), report.describe()


def test_mutant_swapped_push_pop_order():
    bad = []
    for prog in _progs("shifted", tilized=True):
        i = next(i for i, op in enumerate(prog.reader)
                 if type(op).__name__ == "Tilize")
        reader = list(prog.reader)
        reader[i - 1], reader[i] = reader[i], reader[i - 1]
        bad.append(dataclasses.replace(prog, reader=tuple(reader)))
    report = _verify_both(*bad)
    assert "CB-UNDERFLOW" in _codes(report), report.describe()


def test_mutant_undeclared_cb_aborts_deeper_passes():
    bad = [dataclasses.replace(
        p, writer=(dataclasses.replace(p.writer[-1], cb="nope"),))
        for p in _progs("rowchunk")]
    report = _verify_both(*bad)
    assert _codes(report) >= {"CB-UNDECLARED"}
    assert TA.occupancy_bounds(bad[1]) is None


def test_mutant_cb_file_budget():
    bad = []
    for prog in _progs("rowchunk"):
        extras = tuple(dataclasses.replace(prog.cbs[0], name=f"pad{i}")
                       for i in range(prog.plan.device.cb_count))
        bad.append(dataclasses.replace(prog, cbs=prog.cbs + extras))
    assert "BUD-CBFILE" in _codes(_verify_both(*bad))


def test_mutant_sram_budget():
    bad = []
    for prog in _progs("rowchunk"):
        tiny = dataclasses.replace(prog.plan.device, name="sram_poor",
                                   fast_memory_bytes=4096)
        bad.append(dataclasses.replace(
            prog, plan=dataclasses.replace(prog.plan, device=tiny)))
    report = _verify_both(*bad)
    msg = next(d for d in report.errors if d.code == "BUD-SRAM").message
    assert "MiB of fast memory" in msg and "sram_poor" in msg


def test_mutant_double_push_rate_drift():
    bad = []
    for prog, ir in zip(_progs("rowchunk"), (JIR, TIR)):
        rb = next(op for op in prog.reader if isinstance(op, ir.ReadBlock))
        bad.append(dataclasses.replace(prog, reader=prog.reader + (rb,)))
    report = _verify_both(*bad)
    assert {"CB-OVERFLOW", "DL-RATE"} <= _codes(report), report.describe()


def test_counterexample_trace_names_op_and_iteration():
    jprog, tprog = _progs("rowchunk")
    report = _verify_both(_shrink_cb(jprog, JIR), _shrink_cb(tprog, TIR))
    diag = next(d for d in report.errors if d.code == "CB-OVERFLOW")
    assert "reader[0]" in diag.span and "read_block" in diag.span
    assert "iteration 0" in diag.message
    assert "capacity" in diag.message and diag.hint


# ---------------------------------------------------------------------------
# Acceptance: every unmutated registry lowering verifies clean.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("spec", list(SPECS))
def test_unmutated_lowerings_accepted(policy, spec):
    for tilized in (False, True):
        jprog, tprog = _progs(policy, spec=spec, tilized=tilized)
        assert _verify_both(jprog, tprog).ok
        bounds = TA.occupancy_bounds(tprog)
        assert bounds == {k: TA.CBBounds(b.min_tiles, b.max_tiles,
                                         b.capacity)
                          for k, b in JA.occupancy_bounds(jprog).items()}
        for cb in tprog.cbs:
            b = bounds[cb.name]
            assert 0 <= b.min_tiles <= b.max_tiles <= cb.capacity_tiles


def test_masked_temporal_accepted_and_described():
    jprog, tprog = _progs("temporal", masked=True)
    assert _verify_both(jprog, tprog).ok
    dump = tprog.describe()
    assert "<- mask stream" in dump and "occ[" in dump


def test_accepted_programs_run_clean_in_sim():
    rng = np.random.default_rng(7)
    ran = 0
    for _ in range(12):
        ny = int(rng.integers(3, 40)) + 2
        nx = int(rng.integers(3, 50)) + 2
        policy = str(rng.choice(TB.lowerable_policies()))
        t = int(rng.integers(1, 5))
        bm = int(rng.integers(1, 24))
        try:
            prog = TB.lower((ny, nx), torch.float32, TS.jacobi_2d_5pt(),
                            policy, t=t, bm=bm, device=DEV)
        except (LoweringError, PlanError):
            continue
        assert TA.verify_program(prog).ok
        u = torch.from_numpy(rng.random((ny, nx)).astype(np.float32))
        mask = torch.zeros((ny, nx)) if prog.plan.masked else None
        TB.sim.run_program(u, prog, mask=mask)  # must not raise
        ran += 1
    assert ran >= 6


def test_rejected_program_refused_before_execution():
    bad = _shrink_cb(_progs("rowchunk")[1], TIR)
    with pytest.raises(TIR.CBOverflowError, match="overflow"):
        TB.simulate_program(torch.zeros(SHAPE), bad)


def test_diagnostic_codes_are_closed_vocabulary():
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        Diagnostic("error", "NOT-A-CODE", "x", "y")
    with pytest.raises(ValueError, match="severity"):
        Diagnostic("fatal", "CB-OVERFLOW", "x", "y")
    assert len(CODES) >= 16


def test_report_surface():
    clean = Report()
    assert clean.ok and not clean and "clean" in clean.describe()
    clean.raise_if_errors(TIR.BackendError)
    rep = TA.verify_program(_drop_push(_progs("dbuf")[1], TIR))
    assert rep and not rep.ok
    assert clean.merged(rep).errors == rep.errors
    with pytest.raises(TIR.BackendError, match="CB-UNFED"):
        rep.raise_if_errors(TIR.BackendError)


# ---------------------------------------------------------------------------
# The verify-sweep, cell for cell against the reference's.
# ---------------------------------------------------------------------------

def _key(cell):
    return (cell.policy, cell.spec, cell.dtype, cell.device, cell.t,
            cell.masked, cell.overlap)


def _outcome(cell):
    codes = (None if cell.report is None
             else tuple(_rows(cell.report)))
    return cell.outcome, cell.detail, codes


def test_default_lane_sweep_equals_the_reference():
    jcells = JSW.run_sweep(ts=(1, 3))
    tcells = TSW.run_sweep(ts=(1, 3))
    assert [_key(c) for c in tcells] == [_key(c) for c in jcells]
    assert [_outcome(c) for c in tcells] == [_outcome(c) for c in jcells]
    verified = [c for c in tcells if c.outcome == "verified"]
    assert not [c for c in tcells if c.outcome == "error"]
    assert {c.policy for c in verified} == set(POLICIES)
    assert any(c.masked for c in verified)
    assert any(c.overlap for c in verified)


#: The gpu_sm90 cells of ``run_sweep(full=True)`` whose outcome differs
#: from the reference's, by (policy, reference outcome, port outcome): the
#: port's 2-D tile plans. K1's 40 x 112 tile is narrower than the 128-wide
#: interior, so no temporal cell lowers (each is refused with
#: "row-blocked"); K4's 32-row blocks fit 227 KiB where the reference's
#: 64-row blocks need 0.31 MiB in f32 (jacobi5) and in bf16 (all specs).
GPU_OUTCOME_DIFFS = {("temporal", "verified", "infeasible"): 72,
                     ("shifted", "infeasible", "verified"): 18}


def test_full_sweep_equals_the_reference_off_the_gpu():
    jcells = JSW.run_sweep(full=True)
    tcells = TSW.run_sweep(full=True)
    assert len(tcells) == len(jcells) == 720
    jd = {_key(c): c for c in jcells}
    td = {_key(c): c for c in tcells}
    assert td.keys() == jd.keys()
    off_gpu = [k for k in jd if k[3] != "gpu_sm90"]
    assert len(off_gpu) == 540
    for k in off_gpu:
        assert _outcome(td[k]) == _outcome(jd[k]), k
    diffs = collections.Counter(
        (k[0], jd[k].outcome, td[k].outcome) for k in jd
        if k[3] == "gpu_sm90" and jd[k].outcome != td[k].outcome)
    assert dict(diffs) == GPU_OUTCOME_DIFFS
    for k in jd:
        if k[3] == "gpu_sm90" and k[0] == "temporal":
            assert "row-blocked" in td[k].detail
    assert not [c for c in tcells if c.outcome == "error"]
    counts = collections.Counter(c.outcome for c in tcells)
    assert counts == {"verified": 642, "infeasible": 78}


def test_cli_exit_contract(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--policy", "rowchunk", "--spec", "jacobi5",
                 "--device", "grayskull_e150"]) == 0
    assert main(["--all"]) == 0
    out = capsys.readouterr().out
    assert ("repro_torch.analysis: 720 cells — 642 verified, 78 "
            "infeasible") in out
    assert "cell timing: n=" in out
