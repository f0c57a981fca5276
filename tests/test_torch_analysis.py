"""The port's diagnostics and schedule feasibility against the JAX package's.

Diagnostic records, their codes and the text of ``Report.describe()``
equal the reference's character for character; ``check_schedule`` and
``check_bucket`` return the same findings (severity, code, span, message,
hint) over a grid of policies, depths, shapes, meshes, masks and
overlap, the refusals included.
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import analysis as JA
from repro.analysis import diagnostics as JD
from repro.core import stencil as JS
from repro.engine import schedule as JSch
from repro_torch import analysis as TA
from repro_torch.analysis import diagnostics as TD
from repro_torch.core import stencil as TS
from repro_torch.engine import schedule as TSch

SPECS = {"jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
         "laplace9": (JS.laplace_2d_9pt(), TS.laplace_2d_9pt())}
SHAPES = [(18, 18), (14, 22), (66, 130), (12, 20)]
MESHES = [None, (1,), (1, 1), (2, 1), (2, 2), (4, 1), (3, 2), (1, 4)]


def _rows(report):
    return [(d.severity, d.code, d.span, d.message, d.hint)
            for d in report.diagnostics]


def _both(j_report, t_report):
    assert _rows(t_report) == _rows(j_report)
    assert t_report.describe() == j_report.describe()
    assert (t_report.ok, bool(t_report)) == (j_report.ok, bool(j_report))


def test_codes_and_severities_equal_the_reference():
    assert TD.CODES == JD.CODES
    assert TD.SEVERITIES == JD.SEVERITIES


@pytest.mark.parametrize("make", ["error", "warning", "info"])
@pytest.mark.parametrize("hint", [None, "do the other thing"])
def test_describe_text_equals_the_reference(make, hint):
    for code in sorted(JD.CODES):
        j = getattr(JD, make)(code, "reader[2] read_block->in",
                              f"a message about {code}", hint)
        t = getattr(TD, make)(code, "reader[2] read_block->in",
                              f"a message about {code}", hint)
        assert t.describe() == j.describe()
    jr = JD.Report((JD.error("CB-UNFED", "cb stage", "m", hint),
                    JD.warning("DL-RATE", "x", "y"),
                    JD.info("OBS-UNMODELED", "trace", "z", hint)))
    tr = TD.Report((TD.error("CB-UNFED", "cb stage", "m", hint),
                    TD.warning("DL-RATE", "x", "y"),
                    TD.info("OBS-UNMODELED", "trace", "z", hint)))
    _both(jr, tr)
    assert len(tr.errors) == 1 and len(tr.warnings) == 1
    assert tr.merged(tr).describe() == jr.merged(jr).describe()


def test_empty_report_and_raise_if_errors_equal_the_reference():
    _both(JD.Report(), TD.Report())
    TD.Report((TD.warning("DL-RATE", "x", "y"),)).raise_if_errors()
    with pytest.raises(ValueError) as je:
        JD.Report((JD.error("AB-ROW", "s", "m"),)).raise_if_errors()
    with pytest.raises(KeyError) as te:
        TD.Report((TD.error("AB-ROW", "s", "m"),)).raise_if_errors(KeyError)
    assert te.value.args[0] == je.value.args[0]


@pytest.mark.parametrize("severity,code", [("fatal", "AB-ROW"),
                                           ("error", "NOT-A-CODE")])
def test_diagnostic_refuses_what_the_reference_refuses(severity, code):
    with pytest.raises(ValueError) as je:
        JD.Diagnostic(severity, code, "s", "m")
    with pytest.raises(ValueError) as te:
        TD.Diagnostic(severity, code, "s", "m")
    assert str(te.value) == str(je.value)


def _schedules(iters, spec_name, shape, policy, t):
    js, ts = SPECS[spec_name]
    kw = dict(shape=shape, policy=policy, t=t, device="cpu_ref")
    return (JSch.build_schedule(iters, spec=js, dtype=jnp.float32, **kw),
            TSch.build_schedule(iters, spec=ts, dtype=torch.float32,
                                torch_device="cpu", **kw))


@pytest.mark.parametrize("policy", ["temporal", "rowchunk", "dbuf",
                                    "shifted", "reference", "auto"])
@pytest.mark.parametrize("mesh", MESHES)
def test_check_schedule_equals_the_reference(policy, mesh):
    for spec_name in SPECS:
        for shape in SHAPES:
            for iters, t in [(16, 8), (19, 4), (24, 8), (7, 3), (1, None)]:
                jsched, tsched = _schedules(iters, spec_name, shape, policy,
                                            t)
                assert dataclasses.asdict(tsched) == \
                    dataclasses.asdict(jsched)
                for masked in (False, True):
                    for overlap in (False, True):
                        jsc = dataclasses.replace(jsched, overlap=overlap)
                        tsc = dataclasses.replace(tsched, overlap=overlap)
                        kw = dict(shape=shape, mesh_shape=mesh,
                                  masked=masked)
                        _both(JA.check_schedule(jsc, spec=SPECS[spec_name][0],
                                                **kw),
                              TA.check_schedule(tsc, spec=SPECS[spec_name][1],
                                                **kw))


def test_check_schedule_refusals_fire_as_in_the_reference():
    """Each refusal at least once: the masked remainder, a fused remainder
    policy, a mesh that does not decompose, an infeasible overlap, and a
    spec of another radius."""
    js, ts = SPECS["jacobi5"]
    seen = set()
    cases = [
        (dict(policy="temporal", iters=19, t=4, fused=True, fused_blocks=4,
              remainder=3, remainder_policy="temporal", radius=1),
         dict(shape=(18, 18), masked=True)),
        (dict(policy="rowchunk", iters=3, t=1, fused=False, fused_blocks=3,
              remainder=0, remainder_policy="rowchunk", radius=1),
         dict(shape=(18, 18), mesh_shape=(3, 2))),
        (dict(policy="temporal", iters=16, t=8, fused=True, fused_blocks=2,
              remainder=0, remainder_policy="rowchunk", radius=1,
              overlap=True),
         dict(shape=(18, 18), mesh_shape=(2, 2))),
        (dict(policy="temporal", iters=16, t=8, fused=True, fused_blocks=2,
              remainder=0, remainder_policy="rowchunk", radius=1,
              overlap=True),
         dict(shape=(66, 130), mesh_shape=None)),
        (dict(policy="temporal", iters=16, t=8, fused=True, fused_blocks=2,
              remainder=0, remainder_policy="rowchunk", radius=2),
         dict(shape=(18, 18))),
    ]
    for fields, kw in cases:
        j = JA.check_schedule(JSch.SweepSchedule(**fields), spec=js, **kw)
        t = TA.check_schedule(TSch.SweepSchedule(**fields), spec=ts, **kw)
        _both(j, t)
        seen |= {d.code for d in t.diagnostics}
    assert seen == {"SCHED-MASK-REMAINDER", "SCHED-REMAINDER-FUSED",
                    "SCHED-MESH-DECOMP", "SCHED-OVERLAP-INFEASIBLE",
                    "SCHED-PROG-MISMATCH"}


@pytest.mark.parametrize("prog_policy,prog_t,prog_device", [
    ("temporal", 8, "grayskull_e150"), ("temporal", 4, "grayskull_e150"),
    ("rowchunk", None, "grayskull_e150"), ("temporal", 8, "cpu_ref")])
def test_check_schedule_with_a_program_names_the_backends(
        prog_policy, prog_t, prog_device):
    """``program=`` cross-checks a lowered Tensix program of the backends
    against the schedule (policy, depth, device) and runs the static
    verifier over it, with the reference's findings and text."""
    from repro.backends.lower import lower as jlower
    from repro_torch.backends.lower import lower as tlower
    jsched, tsched = _schedules(16, "jacobi5", (18, 18), "temporal", 8)
    js, ts = SPECS["jacobi5"]
    jprog = jlower((18, 18), jnp.float32, js, prog_policy, t=prog_t,
                   device=prog_device)
    tprog = tlower((18, 18), torch.float32, ts, prog_policy, t=prog_t,
                   device=prog_device)
    kw = dict(shape=(18, 18), device="grayskull_e150")
    _both(JA.check_schedule(jsched, program=jprog, **kw),
          TA.check_schedule(tsched, program=tprog, **kw))


@pytest.mark.parametrize("changes", [
    {}, {"dtype": "bfloat16"}, {"shape": (12, 22), "dtype": "bfloat16"},
    {"policy": "rowchunk", "t": 1, "device": "gpu_sm90"},
    {"spec": "laplace9"}])
def test_check_bucket_equals_the_reference(changes):
    base = dict(shape=(18, 18), dtype="float32", spec="jacobi5",
                policy="temporal", t=8, device=None)
    got = dict(base, **changes)
    _both(JA.check_bucket(base, got), TA.check_bucket(base, got))
    assert len(TA.check_bucket(base, got).errors) == len(changes)
