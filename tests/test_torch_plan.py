"""The port's device models and planner against the JAX package's.

Row-block plans (every model but a GPU) must equal the reference's; the
``gpu_sm90`` 2-D tile plan must fit the paper's 1026 x 9218 grid where the
reference's full-width window cannot.
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.analysis.diagnostics import budget_message as j_budget_message
from repro.core import stencil as JS
from repro.engine import device as JD
from repro.engine import plan as JP
from repro_torch.analysis.diagnostics import budget_message
from repro_torch.core import stencil as TS
from repro_torch.engine import device as TD
from repro_torch.engine import plan as TP
from repro_torch.obs import metrics

RADIUS2 = ((((-2, 0), (-1, 0), (0, 0), (0, -2), (0, 1)),
            (0.1, 0.3, 0.2, 0.15, 0.25)))
SPECS = {
    "jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
    "laplace9": (JS.laplace_2d_9pt(), TS.laplace_2d_9pt()),
    "radius2": (JS.StencilSpec(*RADIUS2), TS.StencilSpec(*RADIUS2)),
}
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
ROW_BLOCK_DEVICES = ["cpu_ref", "tpu_v5e", "grayskull_e150"]


def test_device_registry_matches_reference():
    assert TD.available_devices() == JD.available_devices()
    for name in TD.available_devices():
        assert (dataclasses.asdict(TD.get_device(name))
                == dataclasses.asdict(JD.get_device(name))), name


def test_detect_without_a_card_is_cpu_ref():
    want = "gpu_sm90" if (torch.cuda.is_available() and
                          torch.cuda.get_device_capability(0) == (9, 0)) \
        else "cpu_ref"
    assert TD.detect().name == want


def test_budget_message_matches_reference():
    dev = TD.get_device("grayskull_e150")
    assert budget_message("x", 3 * 2**20, dev) == j_budget_message(
        "x", 3 * 2**20, JD.get_device("grayskull_e150"))


def _same_plan(jp, tp):
    for f in ("policy", "shape", "dtype", "bm", "t", "window_rows",
              "vmem_bytes", "masked", "nblocks", "interior_shape", "radius",
              "dtype_bytes"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert dataclasses.asdict(tp.device) == dataclasses.asdict(jp.device)
    assert tp.bn == tp.interior_shape[1]
    assert tp.window_cols == tp.shape[1]


@pytest.mark.parametrize("device", ROW_BLOCK_DEVICES)
@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal"])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_row_block_plans_equal_reference(device, policy, spec_name):
    js, ts = SPECS[spec_name]
    r = ts.radius
    for (jd, td) in DTYPES:
        for shape, bm, t in [((32 + 2 * r, 64 + 2 * r), None, None),
                             ((30 + 2 * r, 128 + 2 * r), 7, 3),
                             ((258, 258), 64, 4)]:
            try:
                jp = JP.plan_for(shape, jd, js, policy, bm=bm, t=t,
                                 device=device)
            except JP.PlanError as e:
                with pytest.raises(TP.PlanError) as got:
                    TP.plan_for(shape, td, ts, policy, bm=bm, t=t,
                                device=device)
                assert str(got.value) == str(e)
                continue
            _same_plan(jp, TP.plan_for(shape, td, ts, policy, bm=bm, t=t,
                                       device=device))


@pytest.mark.parametrize("device", ROW_BLOCK_DEVICES)
def test_masked_and_budget_errors_equal_reference(device):
    js, ts = SPECS["jacobi5"]
    jp = JP.plan_for((66, 130), jnp.float32, js, "temporal", t=3,
                     device=device, masked=True)
    _same_plan(jp, TP.plan_for((66, 130), torch.float32, ts, "temporal",
                               t=3, device=device, masked=True))
    # Budget overflow: the same sentence, word for word.
    args = ((4098, 4098), "temporal")
    with pytest.raises(JP.PlanError) as want:
        JP.plan_for(args[0], jnp.float32, js, args[1], bm=4096, t=64,
                    device=device)
    with pytest.raises(TP.PlanError) as got:
        TP.plan_for(args[0], torch.float32, ts, args[1], bm=4096, t=64,
                    device=device)
    assert str(got.value) == str(want.value)


def test_validation_errors_equal_reference():
    for args in [((34, 130), JS.advection_1d_3pt(), TS.advection_1d_3pt(),
                  "rowchunk", {}),
                 ((2, 130), JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt(),
                  "rowchunk", {}),
                 ((34, 130), JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt(),
                  "temporal", {"t": 0}),
                 ((34, 130), JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt(),
                  "warp9", {}),
                 ((34, 130), JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt(),
                  "dbuf", {"masked": True})]:
        shape, js, ts, policy, kw = args
        with pytest.raises(JP.PlanError) as want:
            JP.plan_for(shape, jnp.float32, js, policy, device="cpu_ref",
                        **kw)
        with pytest.raises(TP.PlanError) as got:
            TP.plan_for(shape, torch.float32, ts, policy, device="cpu_ref",
                        **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("policy,t", [("rowchunk", None), ("dbuf", None),
                                      ("temporal", 8)])
def test_gpu_2d_plan_fits_paper_grid(policy, t, jd, td):
    """The reference's full-width window cannot fit 227 KiB on a 9218-wide
    grid; the port's 2-D tiles do."""
    ts = TS.jacobi_2d_5pt()
    with pytest.raises(JP.PlanError):
        JP.plan_for((1026, 9218), jd, JS.jacobi_2d_5pt(), policy, t=t,
                    device="gpu_sm90")
    plan = TP.plan_for((1026, 9218), td, ts, policy, t=t, device="gpu_sm90")
    assert plan.tiled_2d
    assert plan.vmem_bytes <= TD.get_device("gpu_sm90").fast_memory_bytes
    bm, bn = TP.GPU_TILES[policy]
    if policy != "temporal":  # K2's and K3's width leaves four blocks an SM
        bn = TP.sweep_bn(policy, td.itemsize, ts, bm, bn,
                         TD.get_device("gpu_sm90"))
    assert (plan.bm, plan.bn) == (bm, bn)
    assert plan.t == (t or 1)
    assert plan.halo == (8 if policy == "temporal" else 1)
    assert plan.window_rows == plan.bm + 2 * plan.halo
    assert plan.window_cols == plan.bn + 2 * plan.halo
    assert plan.nblocks == -(-1024 // plan.bm) * -(-9216 // plan.bn) >= (
        2 * 132)
    assert f"bn={plan.bn}" in plan.describe()


def test_gpu_2d_plan_edges_and_limits():
    ts = TS.jacobi_2d_5pt()
    # Tiles clip to a small interior and need not divide it.
    small = TP.plan_for((32, 66), torch.float32, ts, "temporal", t=4,
                        device="gpu_sm90")
    assert (small.bm, small.bn) == (30, 64) and small.nblocks == 1
    ragged = TP.plan_for((102, 302), torch.float32, ts, "rowchunk",
                         bm=64, bn=128, device="gpu_sm90")
    assert (ragged.row_tiles, ragged.col_tiles) == (2, 3)
    # Radius-2 temporal: a t*r = 16-deep halo still fits.
    r2 = SPECS["radius2"][1]
    assert TP.plan_for((1028, 9220), torch.float32, r2, "temporal", t=8,
                       device="gpu_sm90").halo == 16
    # t larger than the tile allows is a PlanError, never a silent answer.
    with pytest.raises(TP.PlanError, match="gpu_sm90"):
        TP.plan_for((1026, 9218), torch.float32, ts, "temporal", t=64,
                    device="gpu_sm90")
    # A masked temporal tile pays one byte a cell for the pin set.
    m = TP.plan_for((1026, 9218), torch.float32, ts, "temporal", t=8,
                    device="gpu_sm90", masked=True)
    # The compiled 5-point K1 keeps rows of TEMPORAL_ROW f32 cells; the
    # general K1 (any other tap order) rows of bn + 2·t·r.
    cells = (40 + 16) * TP.TEMPORAL_ROW
    assert m.vmem_bytes == 9 * cells
    other = TS.StencilSpec(ts.offsets[::-1], ts.weights[::-1])
    g = TP.plan_for((1026, 9218), torch.float32, other, "temporal", t=8,
                    device="gpu_sm90", masked=True)
    assert g.vmem_bytes == 9 * (40 + 16) * (112 + 16)
    assert TP.plan_for((1026, 9218), torch.float32, ts, "shifted",
                       device="gpu_sm90").vmem_bytes == 0
    too_many = TS.StencilSpec(tuple((0, k % 3 - 1) for k in range(33)),
                              (0.01,) * 33)
    with pytest.raises(TP.PlanError, match="taps"):
        TP.plan_for((34, 66), torch.float32, too_many, "rowchunk",
                    device="gpu_sm90")


def test_dbuf_pitch_covers_the_word_shift():
    """A K2/K3 window row holds the 16-byte chunks that cover its bn + 2r
    cells wherever the first cell falls in its chunk (any element offset
    of a row that is no multiple of 16 bytes), between its slack."""
    assert TP.window_pitch(504, 1, 2) == 16 + 65 * 16 + 32
    assert TP.window_pitch(504, 1, 4) == 16 + 128 * 16 + 32
    assert TP.window_pitch(128, 1, 4) == 16 + 34 * 16 + 32
    assert TP.window_pitch(127, 2, 2) == 16 + 18 * 16 + 32
    for bn in (1, 7, 8, 127, 128, 504, 1016):
        for r in (1, 2, 3):
            for esz in (2, 4):
                pitch = TP.window_pitch(bn, r, esz)
                data = pitch - TP.WINDOW_LEAD - TP.WINDOW_TAIL
                assert pitch % 16 == 0 and data % 16 == 0
                span = (bn + 2 * r) * esz
                for shift in range(0, 16, esz):
                    assert -(-(shift + span) // 16) * 16 <= data


def test_window_constants_match_the_compiled_source():
    """The window slack, K3's ring and its mbarrier bytes are the ones
    stencil.cu compiles, and its pitch rule is plan.window_pitch."""
    import pathlib
    import re
    src = (pathlib.Path(TP.__file__).parents[1] / "csrc"
           / "stencil.cu").read_text()
    defined = {name: int(v) for name, v in re.findall(
        r"#define (WIN_LEAD|WIN_TAIL|DBUF_STAGES|DBUF_BARS) (\d+)", src)}
    assert defined == {"WIN_LEAD": TP.WINDOW_LEAD,
                       "WIN_TAIL": TP.WINDOW_TAIL,
                       "DBUF_STAGES": TP.DBUF_STAGES,
                       "DBUF_BARS": TP.DBUF_BARS}
    assert ("return WIN_LEAD + (span + 16 - esz + 15) / 16 * 16 + WIN_TAIL;"
            in src)
    # K3's mbarriers: a full and an empty one a stage, 8 bytes each.
    assert 2 * TP.DBUF_STAGES * 8 <= TP.DBUF_BARS and TP.DBUF_BARS % 16 == 0
    # The sweep launchers' geometry codes follow TEMPORAL_GEOMETRIES.
    launcher = src[src.index("dispatch_sweep(int dtype"):]
    for code, struct in enumerate(("Jacobi5", "Laplace9", "Radius2")):
        assert f"case {code}: return geo(Type<{struct}>{{}});" in launcher


@pytest.mark.parametrize("td", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("policy,bm,bn", [
    ("rowchunk", None, None), ("dbuf", None, None), ("rowchunk", 16, 1016),
    ("dbuf", 8, 1016), ("rowchunk", 64, 248), ("dbuf", 32, 120)])
def test_smem_2d_sweep_is_the_window_layout(policy, bm, bn, spec_name, td):
    """K2 allocates one window of bm + 2r rows of window_pitch bytes; K3
    DBUF_STAGES of them behind DBUF_BARS bytes of mbarriers."""
    spec = SPECS[spec_name][1]
    r = spec.radius
    plan = TP.plan_for((1024 + 2 * r, 9216 + 2 * r), td, spec, policy,
                       bm=bm, bn=bn, device="gpu_sm90")
    want_bm, want_bn = (bm, bn) if bm else TP.GPU_TILES[policy]
    if not bm:  # the default width, halved where r = 2 needs it
        want_bn = TP.sweep_bn(policy, td.itemsize, spec, want_bm, want_bn,
                              TD.get_device("gpu_sm90"))
    assert (plan.bm, plan.bn, plan.halo) == (want_bm, want_bn, r)
    window = (want_bm + 2 * r) * TP.window_pitch(want_bn, r, td.itemsize)
    want = window if policy == "rowchunk" else (
        TP.DBUF_BARS + TP.DBUF_STAGES * window)
    assert plan.vmem_bytes == want
    assert TP.smem_2d(policy, td.itemsize, spec, want_bm, want_bn, 1) == (
        r, want)
    assert plan.vmem_bytes <= TD.get_device("gpu_sm90").fast_memory_bytes


@pytest.mark.parametrize("td", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy,bm,bn_bf16,bn_f32", [
    ("rowchunk", None, 1016, 1016), ("dbuf", None, 504, 252),
    ("rowchunk", 64, 254, 127), ("dbuf", 64, 126, 63),
    ("dbuf", 32, 252, 126)])
def test_sweep_default_width_leaves_four_blocks_an_sm(policy, bm, bn_bf16,
                                                      bn_f32, td):
    """K2's and K3's default tiles fit four blocks an SM as they are (K3's
    in f32 at half width); a taller requested bm halves the default width
    until they do again; a requested bn is kept."""
    ts = TS.jacobi_2d_5pt()
    budget = TD.get_device("gpu_sm90").fast_memory_bytes // 4
    plan = TP.plan_for((1026, 9218), td, ts, policy, bm=bm,
                       device="gpu_sm90")
    assert plan.bn == (bn_bf16 if td == torch.bfloat16 else bn_f32)
    assert plan.vmem_bytes <= budget
    assert TP.smem_2d(policy, td.itemsize, ts, plan.bm, 2 * plan.bn,
                      1)[1] > budget or plan.bn == TP.GPU_TILES[policy][1]
    asked = TP.plan_for((1026, 9218), td, ts, policy, bm=bm, bn=100,
                        device="gpu_sm90")
    assert asked.bn == 100


def test_plan_cache_hits_and_counters():
    TP.plan_cache_clear()
    snap = metrics.snapshot()["counters"]
    hit0, miss0 = (snap.get("engine.plan.hit", 0),
                   snap.get("engine.plan.miss", 0))
    ts = TS.jacobi_2d_5pt()
    p1 = TP.plan_for((34, 130), torch.float32, ts, "rowchunk", bm=16,
                     device="cpu_ref")
    p2 = TP.plan_for((34, 130), "float32", ts, "rowchunk", bm=16,
                     device="cpu_ref")
    assert p1 is p2
    info = TP.plan_cache_info()
    assert info.misses == 1 and info.hits == 1
    snap = metrics.snapshot()["counters"]
    assert snap["engine.plan.miss"] - miss0 == 1
    assert snap["engine.plan.hit"] - hit0 == 1


def test_pick_bm_matches_reference():
    for h, bm in [(1024, 256), (30, 7), (12, 100)]:
        assert TP.pick_bm(h, bm) == JP.pick_bm(h, bm)
    with pytest.warns(UserWarning, match="bm=1"):
        assert TP.pick_bm(1021, 64) == 1


@pytest.mark.parametrize("offsets,weights,variant", [
    (TS.jacobi_2d_5pt().offsets, TS.jacobi_2d_5pt().weights, "jacobi5"),
    (TS.jacobi_2d_5pt().offsets, (0.1, 0.2, 0.3, 0.4), "jacobi5"),
    (TS.laplace_2d_9pt().offsets, TS.laplace_2d_9pt().weights, "laplace9"),
    (*RADIUS2, "radius2"),
    (TS.jacobi_2d_5pt().offsets[::-1], (0.25,) * 4, "general"),
    (TS.laplace_2d_9pt().offsets[1:] + TS.laplace_2d_9pt().offsets[:1],
     TS.laplace_2d_9pt().weights, "general"),
    (TS.advection_2d_3pt().offsets, TS.advection_2d_3pt().weights,
     "general"),
    (TS.jacobi_2d_5pt().offsets[:3], (0.3,) * 3, "general"),
])
def test_temporal_variant_is_an_exact_ordered_match(offsets, weights,
                                                    variant):
    """A compiled K1 geometry runs only a spec with its offsets in its tap
    order; weights are run-time arguments and do not matter."""
    assert TP.temporal_variant(TS.StencilSpec(offsets, weights)) == variant


def test_temporal_geometries_match_the_compiled_source():
    """The table the wrapper matches against is the one stencil.cu
    compiles, geometry for geometry, in the launcher's order."""
    import pathlib
    import re
    src = (pathlib.Path(TP.__file__).parents[1] / "csrc"
           / "stencil.cu").read_text()
    structs = {"jacobi5": "Jacobi5", "laplace9": "Laplace9",
               "radius2": "Radius2"}
    assert list(structs) == list(TP.TEMPORAL_GEOMETRIES)
    quads = int(re.search(r"#define QUADS (\d+)", src).group(1))
    assert "#define TROW (4 * QUADS)" in src
    assert TP.TEMPORAL_ROW == 4 * quads
    launcher = src[src.index("repro_temporal_geo("):]
    for code, (name, struct) in enumerate(structs.items()):
        body = src[src.index(f"struct {struct} {{"):]
        body = body[:body.index("\n};")]
        arrays = [tuple(int(v) for v in m.split(","))
                  for m in re.findall(r"a\[N\] = \{([^}]*)\}", body)]
        assert tuple(zip(*arrays)) == TP.TEMPORAL_GEOMETRIES[name]
        assert f"case {code}: return run(type, Type<{struct}>{{}});" in (
            launcher)


@pytest.mark.parametrize("spec_name,bm,bn,t,masked", [
    ("jacobi5", 64, 96, 8, False), ("jacobi5", 64, 96, 8, True),
    ("jacobi5", 32, 112, 8, False), ("laplace9", 16, 64, 3, False),
    ("radius2", 64, 96, 8, True), ("radius2", 128, 96, 1, False)])
def test_smem_2d_temporal_is_the_compiled_layout(spec_name, bm, bn, t,
                                                 masked):
    """Two f32 tiles of (bm + 2tr) rows of TEMPORAL_ROW cells, plus a pin
    byte a cell when masked; the general K1 keeps bn + 2tr columns."""
    spec = SPECS[spec_name][1]
    r = spec.radius
    rows = bm + 2 * t * r
    halo, nbytes = TP.smem_2d("temporal", 2, spec, bm, bn, t, masked)
    assert halo == t * r
    assert nbytes == rows * TP.TEMPORAL_ROW * (9 if masked else 8)
    general = TS.StencilSpec(spec.offsets[::-1], spec.weights[::-1])
    assert TP.smem_2d("temporal", 2, general, bm, bn, t, masked)[1] == (
        rows * (bn + 2 * t * r) * (9 if masked else 8))
    plan = TP.plan_for((1026 + 2 * r - 2, 9218 + 2 * r - 2), torch.bfloat16,
                       spec, "temporal", bm=bm, bn=bn, t=t, masked=masked,
                       device="gpu_sm90")
    assert plan.vmem_bytes == nbytes and plan.bn == bn


@pytest.mark.parametrize("spec_name,t,bn", [
    ("jacobi5", 8, 112), ("jacobi5", 16, 96), ("jacobi5", 20, 88),
    ("radius2", 8, 96), ("radius2", 12, 80), ("laplace9", 63, 2)])
def test_compiled_temporal_tile_fits_one_row(spec_name, t, bn):
    """A compiled K1's window, bn + 2·t·r, fits one TEMPORAL_ROW row: the
    default bn clips to it, and a halo that fills the row is refused."""
    spec = SPECS[spec_name][1]
    plan = TP.plan_for((1026, 9218), torch.float32, spec, "temporal", t=t,
                       device="gpu_sm90")
    assert plan.bn == bn
    assert plan.bn + 2 * plan.halo <= TP.TEMPORAL_ROW
    with pytest.raises(TP.PlanError, match="gpu_sm90"):
        TP.plan_for((1026, 9218), torch.float32, spec, "temporal",
                    t=TP.TEMPORAL_ROW // (2 * spec.radius),
                    device="gpu_sm90")

