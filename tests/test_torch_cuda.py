"""The CUDA kernels against their plain versions, on the card.

Needs a CUDA card and nvcc; skipped without them. Run on the card with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every kernel computes the plain version's f32 operations in the same
order, so each comparison is bit for bit. Shapes are small but cover the
ragged right and bottom tiles, a radius-2 spec, bf16 grids of every row
alignment, views at an offset, a batch and a pin mask.
"""
import pytest
import torch

from repro_torch import engine as TE
from repro_torch.core import stencil as TS

pytestmark = pytest.mark.gpu

RADIUS2 = TS.StencilSpec(offsets=((-2, 0), (-1, 0), (0, 0), (0, -2), (0, 1)),
                         weights=(0.1, 0.3, 0.2, 0.15, 0.25))
SPECS = {"jacobi5": TS.jacobi_2d_5pt(), "laplace9": TS.laplace_2d_9pt(),
         "radius2": RADIUS2}
SHAPES = [(70, 300), (133, 259), (20, 40)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _grid(shape, dtype, dev, seed=0, batch=None):
    g = torch.Generator().manual_seed(seed)
    full = shape if batch is None else (batch, *shape)
    return torch.rand(full, generator=g).to(dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal"])
def test_kernel_equals_plain_bitwise(cuda, policy, spec_name, shape, dtype):
    spec = SPECS[spec_name]
    u = _grid(shape, dtype, cuda)
    kw = {"t": 3} if policy == "temporal" else {}
    before = TE.LAUNCHES[policy]
    got = getattr(TE, f"stencil_{policy}")(u, spec, bm=16, **kw)
    torch.cuda.synchronize()
    assert TE.LAUNCHES[policy] == before + 1
    want = getattr(TE, f"stencil_{policy}_plain")(u, spec, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_temporal_mask_and_batch_bitwise(cuda, dtype):
    spec = TS.jacobi_2d_5pt()
    u = _grid((70, 300), dtype, cuda, seed=1, batch=3)
    mask = torch.zeros(u.shape[-2:], dtype=torch.bool, device=cuda)
    mask[:5, :] = mask[:, :7] = True
    mask[30:33, 100:140] = True
    got = TE.stencil_temporal(u, spec, t=4, mask=mask)
    assert torch.equal(got, TE.stencil_temporal_plain(u, spec, t=4,
                                                      mask=mask))
    assert torch.equal(got[:, mask], u[:, mask])


def _counts():
    return dict(TE.LAUNCHES), dict(TE.TEMPORAL_VARIANTS)


def _assert_one_k1(before, variant):
    """Exactly one K1 launch since ``before``, and it ran ``variant``."""
    launches, variants = _counts()
    assert launches["temporal"] == before[0]["temporal"] + 1
    assert {k: variants[k] - before[1][k] for k in variants} == {
        k: int(k == variant) for k in variants}


@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_temporal_geometry_equals_plain_bitwise(cuda, spec_name, shape, dtype,
                                                t):
    """Each compiled K1 geometry, on ragged shapes, at the default tile."""
    spec = SPECS[spec_name]
    u = _grid(shape, dtype, cuda, seed=4)
    before = _counts()
    got = TE.stencil_temporal(u, spec, t=t)
    torch.cuda.synchronize()
    _assert_one_k1(before, spec_name)
    assert torch.equal(got, TE.stencil_temporal_plain(u, spec, t=t))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_temporal_interior_and_edge_tiles_bitwise(cuda, spec_name, dtype):
    """300 x 1100 at the default tile has blocks whose window meets no ring
    (no pin test) beside edge blocks (the test), odd width included."""
    spec = SPECS[spec_name]
    u = _grid((300, 1101), dtype, cuda, seed=5)
    plan = TE.plan_for(u.shape, u.dtype, spec, "temporal", t=8)
    assert plan.row_tiles >= 3 and plan.col_tiles >= 3
    before = _counts()
    got = TE.stencil_temporal(u, spec, t=8)
    torch.cuda.synchronize()
    _assert_one_k1(before, spec_name)
    assert torch.equal(got, TE.stencil_temporal_plain(u, spec, t=8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_temporal_geometry_batch_and_mask_bitwise(cuda, spec_name, dtype):
    spec = SPECS[spec_name]
    u = _grid((133, 259), dtype, cuda, seed=6, batch=3)
    g = torch.Generator().manual_seed(7)
    mask = (torch.rand(u.shape, generator=g) < 0.02).to(cuda)
    mask[1, 40:60, 100:150] = True
    before = _counts()
    got = TE.stencil_temporal(u, spec, t=8, mask=mask)
    torch.cuda.synchronize()
    _assert_one_k1(before, spec_name)
    assert torch.equal(got, TE.stencil_temporal_plain(u, spec, t=8,
                                                      mask=mask))
    assert torch.equal(got[mask], u[mask])


@pytest.mark.parametrize("dtype", DTYPES)
def test_temporal_other_tap_order_takes_the_general_kernel(cuda, dtype):
    """jacobi5's offsets in another order match no compiled geometry."""
    j5 = SPECS["jacobi5"]
    spec = TS.StencilSpec(j5.offsets[::-1], (0.1, 0.2, 0.3, 0.4))
    u = _grid((70, 300), dtype, cuda, seed=8)
    before = _counts()
    got = TE.stencil_temporal(u, spec, t=8)
    torch.cuda.synchronize()
    _assert_one_k1(before, "general")
    assert torch.equal(got, TE.stencil_temporal_plain(u, spec, t=8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_shifted_views_launch_equals_the_policy_call(cuda, spec_name, dtype):
    """K4 launched alone on the wrapper's own views gives the policy
    call's result."""
    spec = SPECS[spec_name]
    u = _grid((70, 300), dtype, cuda, seed=9, batch=2)
    plan = TE.plan_for(u.shape[-2:], u.dtype, spec, "shifted")
    out = torch.empty_like(u)
    TE.policies.copy_ring(u, out, spec.radius)
    views = TE.shifted_views(u, spec)
    before = TE.LAUNCHES["shifted"]
    got = TE.launch_shifted_views(plan, views, out)
    torch.cuda.synchronize()
    assert got is out and TE.LAUNCHES["shifted"] == before + 1
    assert torch.equal(got, TE.stencil_shifted(u, spec))
    assert TE.LAUNCHES["shifted"] == before + 2
    with pytest.raises(ValueError, match="contiguous views"):
        TE.launch_shifted_views(plan, views[:-1], out)


def test_run_schedules_equal_plain_schedules(cuda):
    spec = TS.laplace_2d_9pt()
    u = _grid((70, 300), torch.float32, cuda, seed=2)
    got = TE.run(u, spec, iters=11, t=4)
    want = u
    for _ in range(2):
        want = TE.stencil_temporal_plain(want, spec, t=4)
    for _ in range(3):
        want = TE.stencil_rowchunk_plain(want, spec)
    assert torch.equal(got, want)
    assert torch.equal(TE.run(u.clone(), spec, iters=11, t=4, donate=True),
                       want)
    lanes = _grid((70, 300), torch.float32, cuda, seed=3, batch=2)
    batched = TE.run_batched(lanes, spec, iters=11, t=4)
    for i in range(2):
        assert torch.equal(batched[i], TE.run(lanes[i].clone(), spec,
                                              iters=11, t=4))


@pytest.mark.parametrize("donate", [False, True])
def test_engine_launches_spans_count_the_card_launches(cuda, donate):
    """The ``launches`` of the ``engine.launches`` spans equal the
    kernels launched, and the traced runs equal the untraced ones."""
    from repro_torch.obs.trace import Tracer, use_tracer
    spec = TS.jacobi_2d_5pt()
    u = _grid((70, 300), torch.float32, cuda, seed=4)
    want = TE.run(u.clone(), spec, iters=11, t=4)
    want_conv = TE.run_converged(u.clone(), spec, tol=None, max_iters=24,
                                 t=8)[0]
    tracer = Tracer()
    before = sum(TE.LAUNCHES.values())
    with use_tracer(tracer):
        got = TE.run(u.clone(), spec, iters=11, t=4, donate=donate)
        got_conv = TE.run_converged(u.clone(), spec, tol=None, max_iters=24,
                                    t=8, donate=donate)[0]
    torch.cuda.synchronize()
    spans = [e for e in tracer.events if e.name == "engine.launches"]
    assert [e.path[0] for e in spans] == ["engine.run"] + \
        ["engine.run_converged"] * 3
    assert sum(e.attrs["launches"] for e in spans) == \
        sum(TE.LAUNCHES.values()) - before == 5 + 3
    assert torch.equal(got, want) and torch.equal(got_conv, want_conv)


def test_bad_inputs_raise(cuda):
    spec = TS.jacobi_2d_5pt()
    u = _grid((20, 40), torch.float64, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TE.stencil_rowchunk(u, spec)
    u = _grid((20, 40), torch.float32, cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        TE.stencil_rowchunk(u, spec)
    with pytest.raises(TE.PlanError, match="2-D tile plan"):
        TE.stencil_rowchunk(u.contiguous(), spec, device="cpu_ref")


# --------------------- K2 rowchunk and K3 dbuf windows ---------------------

def _spec_of(n, r, seed):
    """n taps at distinct offsets within radius r (the radius reached),
    weights from a seed: specs at the general kernels' tap bounds."""
    g = torch.Generator().manual_seed(seed)
    ring = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    order = torch.randperm(len(ring), generator=g).tolist()
    offs = [(-r, 0)] + [ring[i] for i in order if ring[i] != (-r, 0)]
    w = (torch.rand(n, generator=g) - 0.3).tolist()
    return TS.StencilSpec(tuple(offs[:n]), tuple(w))


J5 = SPECS["jacobi5"]
SWEEP_SPECS = {**SPECS,  # the compiled geometries, then the general kernel
               "jacobi5_reversed": TS.StencilSpec(J5.offsets[::-1],
                                                  (0.1, 0.2, 0.3, 0.4)),
               "taps8": _spec_of(8, 1, 11), "taps16": _spec_of(16, 2, 12),
               "taps32": _spec_of(32, 3, 13)}
# bf16 rows of every residue mod 16 bytes (W = 128 .. 135), the paper's
# width, and grids smaller than one tile.
SWEEP_SHAPES = [(37, w) for w in range(128, 136)] + [(13, 9218), (9, 11),
                                                      (20, 40)]


def _sweep_counts(policy):
    return TE.LAUNCHES[policy], dict(getattr(TE,
                                             f"{policy.upper()}_VARIANTS"))


def _assert_one_sweep(policy, before, variant):
    launches, variants = _sweep_counts(policy)
    assert launches == before[0] + 1
    assert {k: variants[k] - before[1][k] for k in variants} == {
        k: int(k == variant) for k in variants}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
@pytest.mark.parametrize("spec_name", list(SWEEP_SPECS))
@pytest.mark.parametrize("policy", ["rowchunk", "dbuf"])
def test_sweep_kernels_equal_plain_bitwise(cuda, policy, spec_name, shape,
                                           dtype):
    """K2 and K3 at their default tiles on each compiled geometry and the
    general kernel, at every row alignment, bit for bit."""
    spec = SWEEP_SPECS[spec_name]
    u = _grid(shape, dtype, cuda, seed=14)
    variant = spec_name if spec_name in SPECS else "general"
    before = _sweep_counts(policy)
    got = getattr(TE, f"stencil_{policy}")(u, spec)
    torch.cuda.synchronize()
    _assert_one_sweep(policy, before, variant)
    assert torch.equal(got, getattr(TE, f"stencil_{policy}_plain")(u, spec))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", [(1, 1), (3, 8), (7, 61), (5, 300)])
@pytest.mark.parametrize("spec_name", ["jacobi5", "radius2", "taps16"])
@pytest.mark.parametrize("policy", ["rowchunk", "dbuf"])
def test_sweep_kernels_at_other_tiles_bitwise(cuda, policy, spec_name, tile,
                                              dtype):
    """Ragged tiles, tiles narrower than a chunk, and K3 runs of many
    tiles through its ring, on an odd width and a batch of 3."""
    spec = SWEEP_SPECS[spec_name]
    u = _grid((61, 261), dtype, cuda, seed=15, batch=3)
    plan = TE.plan_for(u.shape[-2:], dtype, spec, policy, bm=tile[0],
                       bn=tile[1], device="gpu_sm90")
    before = _sweep_counts(policy)
    got = TE.policies.launch(plan, u)
    torch.cuda.synchronize()
    _assert_one_sweep(policy, before,
                      spec_name if spec_name in SPECS else "general")
    assert torch.equal(got, getattr(TE, f"stencil_{policy}_plain")(u, spec))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec_name", ["jacobi5", "laplace9", "radius2",
                                       "taps8"])
@pytest.mark.parametrize("policy", ["rowchunk", "dbuf"])
def test_sweep_kernels_take_a_batch_bitwise(cuda, policy, spec_name, dtype):
    spec = SWEEP_SPECS[spec_name]
    u = _grid((133, 259), dtype, cuda, seed=16, batch=3)
    got = getattr(TE, f"stencil_{policy}")(u, spec)
    want = getattr(TE, f"stencil_{policy}_plain")(u, spec)
    assert torch.equal(got, want)
    for i in range(3):
        assert torch.equal(got[i], getattr(TE, f"stencil_{policy}")(u[i],
                                                                    spec))


@pytest.mark.parametrize("offset", [1, 3, 5, 7])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec_name", ["jacobi5", "radius2", "taps8"])
@pytest.mark.parametrize("policy", ["rowchunk", "dbuf"])
def test_sweep_kernels_on_views_at_an_offset(cuda, policy, spec_name, dtype,
                                             offset):
    """Input and output as contiguous views `offset` elements into their
    storage (2 bytes apart in bf16 at offset 1), the output's ring filled
    with a value the kernel must leave alone: only the interior changes,
    bit for bit the plain version's."""
    spec = SWEEP_SPECS[spec_name]
    r = spec.radius
    h, w = 45, 133
    src = _grid((h * w + 2 * offset,), dtype, cuda, seed=17)
    u = src[offset:offset + h * w].view(h, w)
    dst = torch.full((h * w + offset,), -3.0, dtype=dtype, device=cuda)
    out = dst[offset:].view(h, w)
    assert u.is_contiguous() and u.storage_offset() == offset
    got = getattr(TE, f"stencil_{policy}")(u, spec, out=out)
    torch.cuda.synchronize()
    assert got is out
    want = getattr(TE, f"stencil_{policy}_plain")(u, spec)
    assert torch.equal(out[r:-r, r:-r], want[r:-r, r:-r])
    ring = torch.ones((h, w), dtype=torch.bool, device=cuda)
    ring[r:-r, r:-r] = False
    assert bool((out[ring] == -3.0).all()) and bool((dst[:offset] == -3.0
                                                     ).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per", [0, 1, 2, 5, 1000])
def test_dbuf_runs_of_any_length_bitwise(cuda, per, dtype):
    """K3's blocks walk `per` tiles through the ring (0: as many as fill
    the card), down a strip of ragged tiles, bit for bit."""
    from repro_torch.engine import policies as P
    spec = SWEEP_SPECS["laplace9"]
    u = _grid((203, 1101), dtype, cuda, seed=18, batch=2)
    out = torch.empty_like(u)
    P.copy_ring(u, out, 1)
    plan = TE.plan_for(u.shape[-2:], dtype, spec, "dbuf", bm=6, bn=250,
                       device="gpu_sm90")
    n, dy, dx, w = P._tap_args(spec)
    err = P._lib().repro_dbuf(
        u.data_ptr(), out.data_ptr(), 1, P._DTYPE_CODE[dtype], 2, 203, 1101,
        1, plan.bm, plan.bn, plan.row_tiles, plan.col_tiles, per,
        TE.plan.window_pitch(plan.bn, 1, dtype.itemsize), n, dy, dx, w,
        plan.vmem_bytes, torch.cuda.current_stream(u.device).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, TE.stencil_dbuf_plain(u, spec))


@pytest.mark.parametrize("policy", ["rowchunk", "dbuf"])
def test_sweep_launchers_refuse_what_they_do_not_take(cuda, policy):
    """The wrappers refuse other dtypes, strided grids and a row-block
    plan; the C launchers refuse a geometry whose offsets are not the
    spec's, an unknown geometry, too many taps, and a pitch or shared
    memory short of the window's."""
    import ctypes
    spec = TS.jacobi_2d_5pt()
    fn = getattr(TE, f"stencil_{policy}")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(_grid((20, 40), torch.float64, cuda), spec)
    with pytest.raises(ValueError, match="contiguous"):
        fn(_grid((20, 40), torch.float32, cuda).t(), spec)
    with pytest.raises(TE.PlanError, match="2-D tile plan"):
        fn(_grid((20, 40), torch.float32, cuda), spec, device="cpu_ref")
    from repro_torch.engine import policies as P
    u = _grid((20, 40), torch.float32, cuda)
    out = u.clone()
    plan = TE.plan_for(u.shape, u.dtype, spec, policy, device="gpu_sm90")
    n, dy, dx, w = P._tap_args(spec)
    pitch = TE.plan.window_pitch(plan.bn, 1, 4)
    lib = P._lib()
    stream = torch.cuda.current_stream(u.device).cuda_stream

    def call(geometry=0, taps=n, pitch=pitch, smem=plan.vmem_bytes):
        head = [u.data_ptr(), out.data_ptr(), geometry, 0, 1, 20, 40, 1,
                plan.bm, plan.bn, plan.row_tiles, plan.col_tiles]
        if policy == "dbuf":
            head.append(1)
        return getattr(lib, f"repro_{policy}")(*head, pitch, taps, dy, dx,
                                                w, smem, stream)
    assert call() == 0 and call(geometry=-1) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, P.stencil_rowchunk_plain(u, spec))
    assert call(geometry=1) != 0   # laplace9's kernel for jacobi5's taps
    assert call(geometry=3) != 0
    many = (ctypes.c_int * 33)()
    assert getattr(lib, f"repro_{policy}")(
        *[u.data_ptr(), out.data_ptr(), -1, 0, 1, 20, 40, 1, plan.bm,
          plan.bn, plan.row_tiles, plan.col_tiles]
        + ([1] if policy == "dbuf" else []),
        pitch, 33, many, many, (ctypes.c_float * 33)(), plan.vmem_bytes,
        stream) != 0
    assert call(pitch=pitch - 16) != 0 and call(pitch=pitch + 8) != 0
    assert call(smem=plan.vmem_bytes - 16) != 0
    if policy == "dbuf":  # a negative run length
        head = [u.data_ptr(), out.data_ptr(), 0, 0, 1, 20, 40, 1, plan.bm,
                plan.bn, plan.row_tiles, plan.col_tiles, -1]
        assert lib.repro_dbuf(*head, pitch, n, dy, dx, w, plan.vmem_bytes,
                              stream) != 0


# ------------------------- K8 flash attention -------------------------

FLASH_SHAPES = [(2, 128, 4, 2, 32, True), (1, 256, 8, 8, 16, True),
                (2, 128, 4, 1, 32, False), (1, 64, 2, 2, 64, True),
                (1, 192, 6, 2, 128, True), (2, 96, 3, 3, 256, True),
                (1, 128, 12, 4, 64, True), (4, 2048, 16, 2, 128, True),
                (2, 300, 16, 2, 128, True), (1, 130, 5, 1, 32, False),
                (4, 2048, 32, 32, 112, True), (2, 300, 32, 32, 112, True),
                (1, 256, 8, 4, 112, True), (4, 2048, 16, 16, 80, False),
                (1, 300, 6, 3, 80, True), (4, 2048, 32, 2, 128, True),
                (2, 300, 32, 2, 128, True), (4, 2048, 16, 8, 128, True)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _qkv(b, s, h, kh, hd, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype=dtype, device=dev)
            for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,kh,hd,causal", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, s, h, kh, hd, causal, dtype):
    """Covers GQA groups 1-8 and 16, groups of 3 and 5 (a partial row
    tile), hd 16 to 256, the serving prefills' shapes (qwen2.5-3b's at hd
    128, zamba2-7b's at hd 112, chatglm3-6b's at group 16 and
    internvl2-2b's at group 2) and hubert-xlarge's heads (hd 80,
    non-causal),
    and lengths that are not a multiple of the key tile (32 keys in f32;
    128 in bf16, 64 at hd 256).
    bf16 goes through the wgmma kernel, f32 through the split-TF32 one."""
    from repro_torch.kernels import flash_attention as TF
    q, k, v = _qkv(b, s, h, kh, hd, dtype, cuda)
    before = dict(TF.LAUNCHES)
    got = TF.flash_attention_local(q, k, v, causal=causal, bq=s, bk=s)
    torch.cuda.synchronize()
    ran = {key: n - before[key] for key, n in TF.LAUNCHES.items()}
    bf16 = dtype == torch.bfloat16
    assert ran == {"flash_attention": 1, "flash_attention_wgmma": int(bf16),
                   "flash_attention_tf32": int(not bf16)}
    want = TF.flash_attention_local_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_f32_stays_on_the_cuda_core_kernel(cuda):
    """f32 launches its own kernel (split TF32, csrc/flash_attention.cu)
    once and never the bf16 one."""
    from repro_torch.kernels import flash_attention as TF
    q, k, v = _qkv(2, 256, 16, 2, 128, torch.float32, cuda, seed=1)
    TF.reset_launch_counts()
    got = TF.flash_attention_local(q, k, v)
    torch.cuda.synchronize()
    assert TF.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 0,
                           "flash_attention_tf32": 1}
    torch.testing.assert_close(
        got, TF.flash_attention_local_plain(q, k, v), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,sk,causal", [(130, 200, True),
                                          (200, 130, True), (77, 77, False)])
@pytest.mark.parametrize("group", [1, 3, 5, 8, 16])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 112, 128, 256])
def test_flash_f32_kernel_over_head_dims_groups_and_lengths(cuda, hd, group,
                                                            sq, sk, causal):
    """The split-TF32 kernel within the f32 gate, 2e-5, of its plain
    version at every head dim it takes, GQA groups 1, 3, 5, 8 and 16 (3
    and 5 leave rows of a CTA unused; 16 is chatglm3-6b's), Sq != Sk both ways (causal by absolute
    position), lengths not a multiple of its key tile, and non-causal."""
    from repro_torch.kernels import flash_attention as TF
    g = torch.Generator().manual_seed(hd + group)
    q = torch.randn((2, sq, 2 * group, hd), generator=g).to(cuda)
    k, v = (torch.randn((2, sk, 2, hd), generator=g).to(cuda)
            for _ in range(2))
    before = TF.LAUNCHES["flash_attention_tf32"]
    got = TF.flash_attention_local(q, k, v, causal=causal, bq=sq, bk=sk)
    torch.cuda.synchronize()
    assert TF.LAUNCHES["flash_attention_tf32"] == before + 1
    want = TF.flash_attention_local_plain(q, k, v, causal=causal, bq=sq,
                                          bk=sk)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as TF
    q, k, v = _qkv(1, 128, 4, 2, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dims"):
        TF.flash_attention_local(q, k, v)
    q, k, v = _qkv(1, 128, 4, 2, 32, torch.float16, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TF.flash_attention_local(q, k, v)
    q, k, v = _qkv(1, 128, 4, 2, 32, torch.float32, cuda)
    strided = torch.cat([q, q], dim=-1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        TF.flash_attention_local(strided, k, v)
    with pytest.raises(ValueError, match="sq % bq"):
        TF.flash_attention_local(q, k, v, bq=48)
    shifted = torch.empty(q.numel() + 2, dtype=q.dtype, device=cuda)
    unaligned = shifted[2:].view(q.shape)  # 8 bytes past a 16-byte line
    unaligned.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TF.flash_attention_local(unaligned, k, v)


def test_flash_bf16_kernel_rejects_what_it_does_not_take(cuda):
    """bf16 inputs the wgmma kernel does not take raise; nothing is
    handed to the f32 kernel or the plain version instead."""
    from repro_torch.kernels import flash_attention as TF
    TF.reset_launch_counts()
    q, k, v = _qkv(1, 128, 4, 2, 48, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dims"):
        TF.flash_attention_local(q, k, v)
    q, k, v = _qkv(1, 128, 130, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="at most 64"):
        TF.flash_attention_local(q, k, v)
    q, k, v = _qkv(1, 128, 4, 2, 64, torch.bfloat16, cuda)
    shifted = torch.empty(q.numel() + 4, dtype=q.dtype, device=cuda)
    unaligned = shifted[4:].view(q.shape)  # 8 bytes past a 16-byte line
    unaligned.copy_(q)
    assert unaligned.is_contiguous() and unaligned.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        TF.flash_attention_local(unaligned, k, v)
    assert TF.LAUNCHES == {"flash_attention": 0, "flash_attention_wgmma": 0,
                           "flash_attention_tf32": 0}


def test_smoke_lm_serves_through_the_flash_kernel(cuda):
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2.5-3b"),
                              attn_chunk=16, attn_impl="flash")
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    model.requires_grad_(False)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, 512, 64, dtype=np.int32),
                    max_new_tokens=4) for _ in range(2)]
    TF.reset_launch_counts()
    done = ServeEngine(model, batch_size=2, max_len=72).generate(reqs)
    assert TF.LAUNCHES["flash_attention"] == cfg.n_layers
    assert TF.LAUNCHES["flash_attention_wgmma"] == cfg.n_layers  # bf16
    assert all(len(r.generated) == 4 for r in done)


def test_smoke_hybrid_at_hd_112_serves_through_k8_and_k7(cuda):
    """A zamba2 smoke model widened to head dim 112: a 32-token prefill
    runs the shared block through K8 (bf16: the tensor-core kernel) at
    each of its two applications and every mamba layer's conv through
    K7."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import conv1d as TK
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2-7b"),
                              head_dim=112, attn_chunk=16, attn_impl="flash",
                              ssm_conv_impl="pallas")
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    model.requires_grad_(False)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, 512, 32, dtype=np.int32),
                    max_new_tokens=4) for _ in range(2)]
    TF.reset_launch_counts()
    TK.reset_launch_counts()
    done = ServeEngine(model, batch_size=2, max_len=40).generate(reqs)
    groups = cfg.n_layers // cfg.hybrid_period
    assert TF.LAUNCHES == {"flash_attention": groups,
                           "flash_attention_wgmma": groups,
                           "flash_attention_tf32": 0}
    assert TK.LAUNCHES["conv1d"] == cfg.n_layers
    assert all(len(r.generated) == 4 for r in done)


# ----------------------- K7 depthwise causal conv -----------------------

# (B, L, D, K, bl): the JAX package's test shapes, a D that takes the
# scalar path (not a multiple of 8), a D with a tail tile, K = 1 and 8,
# and a length whose chunk is not a multiple of the 8 time segments.
CONV_SHAPES = [(1, 64, 128, 4, 32), (2, 128, 256, 4, 32),
               (3, 96, 128, 3, 32), (1, 32, 384, 2, 32),
               (2, 50, 100, 4, 512), (1, 40, 5376, 4, 512),
               (2, 33, 72, 1, 11), (1, 70, 264, 8, 7)]


def _conv_inputs(b, l, d, k, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(shape, generator=g) * s).to(dtype=dtype, device=dev)
            for shape, s in (((b, l, d), 1.0), ((k, d), 0.5), ((d,), 1.0))]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,d,k,bl", CONV_SHAPES)
def test_conv1d_kernel_equals_plain_bitwise(cuda, b, l, d, k, bl, dtype,
                                            bias):
    from repro_torch.kernels import conv1d as TK
    x, w, bb = _conv_inputs(b, l, d, k, dtype, cuda)
    bb = bb if bias else None
    before = TK.LAUNCHES["conv1d"]
    got = TK.conv1d_depthwise_causal(x, w, bb, bl=bl)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["conv1d"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, TK.conv1d_depthwise_causal_plain(x, w, bb))


def test_conv1d_kernel_unaligned_view_and_rejections(cuda):
    """A view starting 4 bytes into its storage takes the scalar path."""
    from repro_torch.kernels import conv1d as TK
    x, w, bb = _conv_inputs(2, 64, 129, 4, torch.float32, cuda)
    flat = x.reshape(-1)[1:1 + 2 * 64 * 128].view(2, 64, 128)
    assert flat.data_ptr() % 16 == 4
    got = TK.conv1d_depthwise_causal(flat, w[:, :128].contiguous(),
                                     bb[:128].contiguous())
    want = TK.conv1d_depthwise_causal_plain(flat, w[:, :128], bb[:128])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        TK.conv1d_depthwise_causal(x[..., :128], w[:, :128].contiguous())
    with pytest.raises(ValueError, match="one device"):
        TK.conv1d_depthwise_causal(x, w.cpu())


def test_smoke_mamba_through_the_conv_kernel(cuda):
    """A mamba2 smoke forward through K7 equals the plain-conv route bit
    for bit on the card, and serving launches K7 once a layer a wave."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import conv1d as TK
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(configs.get_smoke_config("mamba2-2.7b"),
                              ssm_conv_impl="pallas")
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    model.requires_grad_(False)
    plain = model.with_config(dataclasses.replace(cfg, ssm_conv_impl="jnp"))
    toks = torch.arange(64, device=cuda)[None].repeat(2, 1) % cfg.vocab_size
    TK.reset_launch_counts()
    got, _, _ = model.forward({"tokens": toks})
    assert TK.LAUNCHES["conv1d"] == cfg.n_layers
    want, _, _ = plain.forward({"tokens": toks})
    assert torch.equal(got, want)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, 512, 32, dtype=np.int32),
                    max_new_tokens=4) for _ in range(2)]
    TK.reset_launch_counts()
    done = ServeEngine(model, batch_size=2, max_len=40).generate(reqs)
    assert TK.LAUNCHES["conv1d"] == cfg.n_layers
    assert all(len(r.generated) == 4 for r in done)


STREAM_DTYPES = [torch.int32, torch.float32, torch.bfloat16]


def _values(shape, dtype, dev, seed=0):
    """Values of a few thousand (ints truncated from them) on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3000).to(dtype).to(dev)


@pytest.mark.parametrize("dtype", STREAM_DTYPES)
@pytest.mark.parametrize("h,w,bm,bn", [
    (256, 4096, 256, 4096), (256, 1024, 256, 8), (1024, 64, 1024, 8),
    (64, 1024, 64, 1024), (96, 258, 32, 129), (256, 1026, 128, 1026),
    (128, 514, 128, 514), (30, 45, 3, 5)])
def test_stream_copy_kernel_equals_plain(cuda, h, w, bm, bn, dtype):
    from repro_torch.kernels import stream as TK
    x = _values((h, w), dtype, cuda)
    before = TK.LAUNCHES["stream_copy"]
    got = TK.stream_copy(x, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["stream_copy"] == before + 1
    assert torch.equal(got, TK.stream_copy_plain(x, bm=bm, bn=bn))


@pytest.mark.parametrize("dtype", STREAM_DTYPES)
@pytest.mark.parametrize("split", [None, 7])
def test_stream_copy_split_tiles_equal_plain(cuda, split, dtype, monkeypatch):
    """The table shape with 16 tiles splits each tile's rows over several
    blocks (16 on 132 SMs); a forced split of 7 does not divide bm = 256."""
    from repro_torch.kernels import stream as TK
    x = _values((4096, 4096), dtype, cuda, seed=3)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want_split = TK.copy_split(4096, 4096, 256, 4096, sms)
    assert 16 * want_split <= 2 * sms < 16 * (want_split + 1)
    if split is not None:
        monkeypatch.setattr(TK, "copy_split", lambda *a: split)
    before = TK.LAUNCHES["stream_copy"]
    got = TK.stream_copy(x, bm=256, bn=4096)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["stream_copy"] == before + 1
    assert torch.equal(got, TK.stream_copy_plain(x, bm=256, bn=4096))


@pytest.mark.parametrize("dtype", STREAM_DTYPES)
@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("h,w,bm", [(256, 4096, 64), (128, 256, 16),
                                    (96, 40, 32), (20, 8, 1)])
def test_stream_rowdma_kernel_equals_plain(cuda, h, w, bm, sync, dtype):
    from repro_torch.kernels import stream as TK
    x = _values((h, w), dtype, cuda, seed=1)
    before = TK.LAUNCHES["stream_copy_rowdma"]
    got = TK.stream_copy_rowdma(x, bm=bm, sync=sync)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["stream_copy_rowdma"] == before + 1
    assert torch.equal(got, x)


@pytest.mark.parametrize("dtype", STREAM_DTYPES)
@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("h,w,bm", [
    (4096, 4096, 64),   # Table III: 64 bm-row blocks (below the SM count)
    (480, 1024, 48),    # 10 bm-row blocks of 48 rows
    (2400, 256, 8),     # 300 bm-row blocks, above the SM count
    (96, 2048, 96)])    # one bm-row block
def test_stream_rowdma_split_equals_plain(cuda, h, w, bm, sync, dtype):
    """K5b bit for bit at the table's shape and with bm-row blocks below
    and above the SM count, with sync (one block a bm-row block) and
    without (one block a row)."""
    from repro_torch.kernels import stream as TK
    x = _values((h, w), dtype, cuda, seed=2)
    plan = TK.rowdma_plan(w * x.element_size(), bm, sync)
    assert plan.split == (1 if sync else bm)
    before = TK.LAUNCHES["stream_copy_rowdma"]
    got = TK.stream_copy_rowdma(x, bm=bm, sync=sync)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["stream_copy_rowdma"] == before + 1
    assert torch.equal(got, TK.stream_copy_rowdma_plain(x, bm=bm, sync=sync))


@pytest.mark.parametrize("plan", [(7, 3), (64, 1), (1, 8), (5, 2), (4, 8)])
def test_stream_rowdma_forced_plans_equal_plain(cuda, plan, monkeypatch):
    """Any split of a bm-row block and ring gives the same copy (7 and 5
    divide no 64; a ring of 8 and a block of 16 rows reuse every slot)."""
    from repro_torch.kernels import stream as TK
    x = _values((1024, 4096), torch.int32, cuda, seed=3)
    monkeypatch.setattr(TK, "rowdma_plan",
                        lambda *a: TK.RowdmaPlan(*plan))
    got = TK.stream_copy_rowdma(x, bm=64, sync=False)
    torch.cuda.synchronize()
    assert torch.equal(got, x)


def test_stream_rowdma_kernel_refuses_rows_it_cannot_move(cuda):
    from repro_torch.kernels import stream as TK
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        TK.stream_copy_rowdma(_values((8, 1026), torch.float32, cuda),
                              bm=8, sync=False)
    flat = _values((8 * 64 + 1,), torch.int32, cuda)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        TK.stream_copy_rowdma(flat[1:].view(8, 64), bm=8, sync=True)
    with pytest.raises(ValueError, match="does not fit"):
        TK.stream_copy_rowdma(_values((2, 65536), torch.float32, cuda),
                              bm=2, sync=False)


@pytest.mark.parametrize("dtype", STREAM_DTYPES)
@pytest.mark.parametrize("factor", [1, 3, 7, 32])
@pytest.mark.parametrize("h,w,bm", [(512, 4096, 128), (96, 258, 32),
                                    (31, 7, 31)])
def test_stream_replicated_kernel_equals_plain(cuda, h, w, bm, factor,
                                               dtype):
    from repro_torch.kernels import stream as TK
    x = _values((h, w), dtype, cuda, seed=factor)
    before = TK.LAUNCHES["stream_replicated"]
    got = TK.stream_replicated(x, bm=bm, factor=factor)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["stream_replicated"] == before + 1
    assert torch.equal(got, TK.stream_replicated_plain(x, bm=bm,
                                                       factor=factor))


def test_stream_replicated_kernel_unaligned_view(cuda):
    """A view 4 bytes into its storage takes the element-wise path."""
    from repro_torch.kernels import stream as TK
    flat = _values((64 * 256 + 1,), torch.float32, cuda)
    x = flat[1:].view(64, 256)
    got = TK.stream_replicated(x, bm=32, factor=5)
    assert torch.equal(got, TK.stream_replicated_plain(x, bm=32, factor=5))


@pytest.mark.parametrize("dtype", STREAM_DTYPES)
@pytest.mark.parametrize("h,w,bm", [(66, 130, 64), (100, 130, 16),
                                    (514, 514, 64), (1026, 9218, 64),
                                    (3, 3, 1), (40, 2000, 256)])
def test_dma_only_kernel_equals_plain(cuda, h, w, bm, dtype):
    from repro_torch.kernels import components as TK
    u = _values((h, w), dtype, cuda, seed=2)
    before = TK.LAUNCHES["dma_only"]
    got = TK.dma_only(u, bm=bm)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["dma_only"] == before + 1
    assert torch.equal(got, TK.dma_only_plain(u, bm=bm))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,bm", [(514, 514, 64), (1026, 9218, 64),
                                    (100, 130, 16), (5, 3, 2),
                                    (300, 1000, 7)])
def test_compute_only_kernel_equals_plain(cuda, h, w, bm, dtype):
    from repro_torch.kernels import components as TK
    u = _values((h, w), dtype, cuda, seed=3)
    before = TK.LAUNCHES["compute_only"]
    got = TK.compute_only(u, bm=bm)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["compute_only"] == before + 1
    assert torch.equal(got, TK.compute_only_plain(u, bm=bm))


def test_access_tables_run_on_the_card(cuda):
    from repro_torch.launch import access
    for table in sorted(access.TABLES):
        for line in access.table_rows(table, cuda, scale=8):
            name, us, _ = line.split(",")
            # Measured rows carry a time; the paper's and the modeled
            # simulator rows carry none.
            assert (float(us) == 0.0) == name.startswith(("paper_",
                                                          "sim_")), line


@pytest.mark.parametrize("unroll", [4, 8])
@pytest.mark.parametrize("n,passes", [(4, 1), (4096, 3), (8196, 2),
                                      (3 * 2**20, 5)])
def test_l2_probe_sum_equals_plain(cuda, n, passes, unroll):
    from repro_torch.kernels import stream as TK
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                      dtype=torch.int32).to(cuda)
    got = TK.l2_read_probe(x, passes=passes, unroll=unroll)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), TK.l2_read_probe_plain(x, passes=passes))


def _solo_tol(u0, policy, target):
    """A tol that a solve of ``u0`` reaches at exactly the new low of its
    solo residual curve (blocks of 8 sweeps) nearest block ``target``:
    halfway between that low and the lowest residual before it. Returns
    (tol, blocks)."""
    u, curve = u0, []
    for _ in range(target + 10):
        u = TE.run(u, policy=policy, iters=8, t=8)
        curve.append(float(TS.residual(u, TS.jacobi_2d_5pt())))
    lows = [b for b in range(1, len(curve)) if curve[b] < min(curve[:b])]
    b = min(lows, key=lambda b: abs(b - target))
    return (min(curve[:b]) + curve[b]) / 2, b + 1


def _serve_on_card(cuda, superblock, policy="temporal", dtype=torch.float32):
    """Five requests of 50 blocks of 8 on four slots; four with tols from
    their own solo curves, one fixed. Returns (server, requests, kernel
    launches, expected blocks, batched blocks, lone blocks)."""
    from repro_torch.obs.trace import Tracer, span_records
    from repro_torch.serve import SolveRequest, SolveServer
    plan = []
    for i, target in enumerate((11, 20, None, 30, 40)):
        u0 = TS.make_laplace_problem(40, 300, dtype=dtype, left=1.0 - 0.1 * i,
                                     device=cuda)
        tol, blocks = (None, 50) if target is None else _solo_tol(
            u0, policy, target)
        plan.append((u0, tol, blocks))
    reqs = [SolveRequest(grid=u0, tol=tol, max_iters=400, policy=policy,
                         t=8) for u0, tol, _ in plan]
    tracer = Tracer()
    srv = SolveServer(max_slots=4, superblock=superblock, tracer=tracer)
    TE.reset_launch_counts()
    srv.solve(reqs)
    torch.cuda.synchronize()
    recs = span_records(tracer)
    batched = sum(r["attrs"]["blocks"] for r in recs
                  if r["name"] == "serve.block" and not r["attrs"].get("lone"))
    lone = sum(r["attrs"]["iters_done"] // 8 for r in recs
               if r["name"] == "engine.run_converged")
    return (srv, reqs, dict(TE.LAUNCHES), [b for *_, b in plan], batched,
            lone)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", ["temporal", "rowchunk"])
def test_served_superblocks_equal_solo_runs(cuda, policy, dtype):
    srv, reqs, launches, blocks, batched, lone = _serve_on_card(
        cuda, 4, policy, dtype)
    for r, b in zip(reqs, blocks):
        assert r.done and r.iters_done == 8 * b
        assert r.result.device.type == "cpu" and r.result.dtype == dtype
        solo = TE.run(r.grid, policy=r.key.policy, iters=r.iters_done,
                      t=r.key.t)
        assert torch.equal(r.result, solo.cpu())
        if r.tol is not None:
            assert r.converged and r.residual <= r.tol
    # a block: the policy's sweeps, then one batched K2 for the residuals
    # (the lone bypass takes its residuals without a kernel)
    sweeps = {"temporal": {"temporal": batched + lone, "rowchunk": batched},
              "rowchunk": {"rowchunk": 9 * batched + 8 * lone}}[policy]
    assert batched > 0 and launches == {"shifted": 0, "rowchunk": 0,
                                        "dbuf": 0, "temporal": 0, **sweeps}
    again = _serve_on_card(cuda, 1, policy, dtype)[1]
    for a, b in zip(reqs, again):
        assert (a.iters_done, a.residual) == (b.iters_done, b.residual)
        assert torch.equal(a.result, b.result)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", ["jacobi5", "laplace9"])
def test_served_residuals_through_k2_equal_residual(cuda, spec, dtype):
    """A superblock's residuals on the card (one batched K2 into a spare
    buffer whose ring is garbage, the difference, one reduction) are bit
    for bit ``residual``'s, a NaN lane included."""
    from repro_torch.serve import solve as SS
    spec = (TS.jacobi_2d_5pt() if spec == "jacobi5"
            else TS.laplace_2d_9pt())
    g = torch.Generator().manual_seed(3)
    vs = torch.randn((3, 130, 517), generator=g).to(dtype).to(cuda)
    vs[1, 40, 200] = float("nan")
    key = SS.BucketKey(shape=(130, 517), dtype=str(dtype)[6:], spec=spec,
                       policy="temporal", t=8, device=None,
                       torch_device="cuda")
    spare = torch.full_like(vs, float("inf"))
    TE.reset_launch_counts()
    got = SS._residuals(vs, key, spare)
    assert TE.LAUNCHES["rowchunk"] == 1
    want = TS.residual(vs, spec)
    assert got.dtype == torch.float32 and got.shape == (3,)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(got[1].isnan())


def test_served_readback_is_pinned_and_waited_on(cuda, monkeypatch):
    """The superblock's history comes back through pinned host memory
    behind an event, and the replay reads it only after that event."""
    from repro_torch.serve import solve as SS
    seen = []
    real = SS._readback

    def spy(xs, dev):
        host, ev = real(xs, dev)
        seen.append((all(h.is_pinned() for h in host), ev))
        return host, ev
    monkeypatch.setattr(SS, "_readback", spy)
    _serve_on_card(cuda, 4)
    assert seen and all(pinned for pinned, _ in seen)
    assert all(isinstance(ev, torch.cuda.Event) and ev.query()
               for _, ev in seen)


def test_solve_server_lone_request_on_the_card(cuda):
    from repro_torch.serve import SolveRequest, SolveServer
    req = SolveRequest(grid=TS.make_laplace_problem(40, 300, device=cuda),
                       tol=3e-3, max_iters=96, policy="temporal", t=8)
    srv = SolveServer(max_slots=4)
    TE.reset_launch_counts()
    srv.solve([req])
    torch.cuda.synchronize()
    assert srv.stats()["launches"] == 1
    assert TE.LAUNCHES["temporal"] == req.iters_done // 8
    assert torch.equal(req.result, TE.run(req.grid, policy="temporal",
                                          iters=req.iters_done,
                                          t=8).cpu())


def test_temporal_takes_a_prepared_uint8_mask_as_it_is(cuda):
    """A contiguous uint8 mask of the grid's shape (the distributed
    executor's pin mask) runs the same as any other form of it."""
    spec = TS.jacobi_2d_5pt()
    u = _grid((70, 300), torch.float32, cuda, seed=2)
    mask = torch.zeros(u.shape, dtype=torch.uint8, device=cuda)
    mask[:8] = 1
    mask[:, -3:] = 7
    got = TE.stencil_temporal(u, spec, t=4, mask=mask)
    assert torch.equal(got, TE.stencil_temporal(u, spec, t=4,
                                                mask=mask.bool()))
    assert torch.equal(got, TE.stencil_temporal_plain(u, spec, t=4,
                                                      mask=mask))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mesh", [((4,), ("x",)), ((2, 2), ("x", "y"))])
@pytest.mark.parametrize("policy", ["reference", "shifted", "rowchunk",
                                    "dbuf", "temporal"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_run_distributed_on_the_card_bitwise(cuda, dtype, spec_name, policy,
                                             mesh, overlap):
    """Four shards on the card (the interior/rind split on a side
    stream): bit for bit the single-device run of the same policy, over
    two rounds of t=3 and a one-sweep remainder round."""
    from repro_torch.dist import ShardMesh
    spec = SPECS[spec_name]
    r = spec.radius
    u = _grid((64 + 2 * r, 128 + 2 * r), dtype, cuda, seed=5)
    got = TE.run_distributed(u, spec, mesh=ShardMesh(*mesh), policy=policy,
                             iters=7, t=3, overlap=overlap)
    want = TE.run(u, spec, policy=policy, iters=7, t=3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Subnormals, flushed in the kernels as in their plain versions
# ---------------------------------------------------------------------------

def _subnormal_grid(shape, dtype, dev, seed=0):
    """Magnitudes up to 16x the smallest normal f32, half negative."""
    g = torch.Generator().manual_seed(seed)
    mag = torch.rand(shape, generator=g) * 16
    neg = torch.rand(shape, generator=g) < 0.5
    u = torch.where(neg, -mag, mag) * TS.F32_TINY
    return u.to(dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal"])
def test_kernels_flush_subnormals_as_their_plain_versions(
        cuda, policy, spec_name, shape, dtype):
    spec = SPECS[spec_name]
    u = _subnormal_grid(shape, dtype, cuda, seed=len(spec_name))
    kw = {"t": 3} if policy == "temporal" else {}
    got = getattr(TE, f"stencil_{policy}")(u, spec, **kw)
    want = getattr(TE, f"stencil_{policy}_plain")(u, spec, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    r = spec.radius
    inner = got[r:-r, r:-r].float()
    assert int(((inner != 0) & (inner.abs() < TS.F32_TINY)).sum()) == 0


def test_main_path_flushes_the_fronts_tail(cuda):
    """Past ~60 sweeps the diffusion front's tail is subnormal: the card's
    engine.run equals its plain schedule and keeps no subnormal cell."""
    u = TS.make_laplace_problem(62, 258, left=1.0, device=cuda)
    for policy in ("rowchunk", "temporal"):
        got = TE.run(u, policy=policy, iters=200, t=8)
        want = TE.run(u.cpu(), policy=policy, iters=200, t=8,
                      device="cpu_ref")
        assert torch.equal(got.cpu(), want)
        x = got.float()
        assert int(((x != 0) & (x.abs() < TS.F32_TINY)).sum()) == 0


# ---------------------------------------------------------------------------
# The Grayskull model's simulator on the card: its twin is engine.run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", ["shifted", "rowchunk", "dbuf",
                                    "temporal"])
def test_simulator_on_the_card_equals_engine_run(cuda, policy, dtype):
    from repro_torch import backends
    u = TS.make_laplace_problem(64, 256, dtype=dtype, device=cuda)
    res = backends.simulate(u, policy=policy, iters=11, t=8, bm=16,
                            device="grayskull_e150")
    assert res.grid.device.type == "cuda"
    assert res.programs[0].tilized == (dtype == torch.bfloat16)
    TE.reset_launch_counts()
    want = TE.run(u, policy=policy, iters=11, t=8, bm=16)
    torch.cuda.synchronize()
    assert TE.LAUNCHES[policy] == (1 if policy == "temporal" else 11)
    assert torch.equal(res.grid, want)
    cpu = backends.simulate(u.cpu(), policy=policy, iters=11, t=8, bm=16,
                            device="grayskull_e150")
    assert torch.equal(cpu.grid, res.grid.cpu())
    assert cpu.counters.as_dict() == res.counters.as_dict()
    assert cpu.model_time_s == res.model_time_s


def test_simulator_mesh_bill_on_the_card(cuda):
    from repro_torch import backends
    u = TS.make_laplace_problem(64, 256, device=cuda)
    kw = dict(policy="temporal", iters=11, t=8, bm=16,
              device="grayskull_e150")
    one = backends.simulate(u, **kw)
    for overlap in (False, True):
        res = backends.simulate(u, mesh_shape=(4,), overlap=overlap, **kw)
        assert torch.equal(res.grid, one.grid)
        bill = res.exchange_model
        assert res.model_time_s == (bill.overlapped_s if overlap
                                    else bill.serial_s)


def test_backends_smoke_and_copy_model_on_the_card(cuda):
    from repro_torch.backends import report
    from repro_torch.backends.sim import _smoke
    assert _smoke("grayskull_e150", "cuda") == 0
    on_card = report.model_copy_seconds((4096, 4096), "int32", seg_cols=1,
                                        device="grayskull_e150")
    on_cpu = report.model_copy_seconds((4096, 4096), "int32", seg_cols=1,
                                       device="grayskull_e150",
                                       torch_device="cpu")
    assert on_card == on_cpu


# ------------------- the paper's Jacobi entry points -------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("version,policy", [("v0", "shifted"),
                                            ("v1", "rowchunk"),
                                            ("v1db", "dbuf"),
                                            ("v2", "temporal")])
def test_versions_launch_their_kernel_once(cuda, version, policy, dtype):
    """``ops.jacobi_step`` and the deprecated wrappers each launch their
    policy's kernel once and equal ``engine.stencil_*`` bit for bit."""
    import warnings

    from repro_torch.kernels import jacobi as TK
    from repro_torch.kernels import ops as TO
    u = _grid((130, 259), dtype, cuda, seed=3)
    spec = TS.jacobi_2d_5pt()
    kw = dict(t=8) if policy == "temporal" else {}
    want = getattr(TE, f"stencil_{policy}")(u, spec, **kw)
    legacy = {"v0": TK.jacobi_v0_shifted, "v1": TK.jacobi_v1_rowchunk,
              "v1db": TK.jacobi_v1_dbuf, "v2": TK.jacobi_v2_temporal}
    for call in (lambda: TO.jacobi_step(u, version=version),
                 lambda: legacy[version](u)):
        TE.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            got = call()
        torch.cuda.synchronize()
        assert TE.LAUNCHES == {p: int(p == policy) for p in TE.LAUNCHES}
        assert torch.equal(got, want)
    TE.reset_launch_counts()
    ref = TO.jacobi_step(u, version="ref")
    assert sum(TE.LAUNCHES.values()) == 0
    assert torch.equal(ref, TS.apply_stencil(u, spec))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_drivers_on_the_card(cuda, dtype):
    """``jacobi_run_temporal`` is ``engine.run(temporal)``: 2 K1 and 3 K2
    launches for 19 sweeps at t = 8; ``jacobi_solve`` stops early on a
    multiple of ``check_every`` and equals ``jacobi_run`` at its count,
    one K2 launch a sweep."""
    from repro_torch.core import jacobi as TJ
    u = TS.make_laplace_problem(126, 254, dtype=dtype, device=cuda)
    TE.reset_launch_counts()
    got = TJ.jacobi_run_temporal(u, 19, t=8)
    torch.cuda.synchronize()
    assert (TE.LAUNCHES["temporal"], TE.LAUNCHES["rowchunk"]) == (2, 3)
    assert torch.equal(got, TE.run(u, policy="temporal", iters=19, t=8))
    TE.reset_launch_counts()
    out, n, res = TJ.jacobi_solve(u, tol=2e-2, max_iters=400,
                                  check_every=20, policy="rowchunk")
    assert 0 < n < 400 and n % 20 == 0 and res <= 2e-2
    assert TE.LAUNCHES["rowchunk"] == n
    assert torch.equal(out, TJ.jacobi_run(u, n, policy="rowchunk"))


def test_smoke_decoders_of_slice_13_on_the_card(cuda):
    """chatglm3 (K8 once a layer in a long prefill), internvl2 (the same,
    and a forward with image embeddings) and minicpm3 (MLA: no K8)."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(1)
    for arch, launches in (("chatglm3-6b", 2), ("internvl2-2b", 2),
                           ("minicpm3-4b", 0)):
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  attn_chunk=16, attn_impl="flash")
        model = build_model(cfg, device=cuda,
                            generator=torch.Generator(cuda).manual_seed(0))
        model.requires_grad_(False)
        reqs = [Request(prompt=rng.integers(0, 512, 64, dtype=np.int32),
                        max_new_tokens=4) for _ in range(2)]
        TF.reset_launch_counts()
        done = ServeEngine(model, batch_size=2, max_len=72).generate(reqs)
        assert TF.LAUNCHES["flash_attention_wgmma"] == launches, arch
        assert all(len(r.generated) == 4 for r in done)
        if cfg.family == "vlm":
            img = torch.randn((2, cfg.vlm_image_tokens, cfg.vlm_vision_dim),
                              device=cuda)
            toks = torch.from_numpy(np.stack([r.prompt[:56] for r in reqs])
                                    ).long().to(cuda)
            logits, _, _ = model.forward({"tokens": toks,
                                          "image_embeds": img})
            assert logits.shape == (2, 64, cfg.padded_vocab)
            assert bool(logits.isfinite().all())


def test_sharded_flash_and_conv_halo_on_the_card(cuda):
    """K8 under a (2, 2) data x model mesh of the card and K7 after the
    conv halo on 4 sequence shards, bit for bit their unsharded calls."""
    from repro_torch.core import ssm_sp
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.mesh import ShardMesh
    from repro_torch.kernels import conv1d as TK
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ops
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((4, 256, 8, 64), generator=g, device=cuda).bfloat16()
    k = torch.randn((4, 256, 2, 64), generator=g, device=cuda).bfloat16()
    whole = TF.flash_attention_local(q, k, k)
    TF.reset_launch_counts()
    with shd.use_mesh(ShardMesh((2, 2), ("data", "model"))):
        got = ops.flash_attention(q, k, k)
    assert TF.LAUNCHES["flash_attention"] == 4
    assert torch.equal(got, whole)
    x = torch.randn((2, 256, 96), generator=g, device=cuda)
    w = torch.randn((4, 96), generator=g, device=cuda)
    mesh = ShardMesh((4,), ("sp",))
    ext = ssm_sp.conv_halo_exchange(
        shd.lay_out(x, (None, "sp"), mesh).shards, 4)
    TK.reset_launch_counts()
    got = torch.cat([TK.conv1d_depthwise_causal(e, w)[:, 3:] for e in ext],
                    1)
    assert TK.LAUNCHES["conv1d"] == 4
    assert torch.equal(got, TK.conv1d_depthwise_causal(x, w))


def test_cost_counter_on_the_card(cuda):
    """Under the counter K8 launches and is counted by its formula; a
    stencil kernel, which has none, raises at its launch."""
    from repro_torch import hlo_analysis as H
    from repro_torch.kernels import flash_attention as TF
    q = torch.randn((1, 256, 4, 64), device=cuda).bfloat16()
    TF.reset_launch_counts()
    with H.CostCounter() as ctr:
        out = TF.flash_attention_local(q, q, q)
    assert TF.LAUNCHES["flash_attention"] == 1
    assert ctr.cost.kernels == {"flash_attention": 1}
    assert ctr.cost.dot_flops == H.flash_cost(q, q, True)[0]
    assert out.shape == q.shape
    u = TS.make_laplace_problem(30, 62, device=cuda)
    with pytest.raises(H.UncountedKernelError):
        with H.CostCounter():
            TE.step(u, TS.jacobi_2d_5pt(), policy="rowchunk")


def test_compressed_psum_card_equals_cpu(cuda):
    from repro_torch.train.compression import EFState, compressed_psum
    g = torch.Generator(cuda).manual_seed(0)
    grads = [{"w": torch.randn((64, 32), generator=g, device=cuda)}
             for _ in range(4)]
    res = [EFState({"w": torch.randn((64, 32), generator=g, device=cuda)
                    * 1e-3}) for _ in range(4)]
    for mode in ("int8", "bf16"):
        m_c, e_c = compressed_psum(grads, res, mode)
        m_h, e_h = compressed_psum(
            [{"w": d["w"].cpu()} for d in grads],
            [EFState({"w": e.residual["w"].cpu()}) for e in res], mode)
        for r in range(4):
            assert torch.equal(m_c[r]["w"].cpu(), m_h[r]["w"])
            assert torch.equal(e_c[r].residual["w"].cpu(),
                               e_h[r].residual["w"])


def test_int8_scale_and_mean_divide_as_on_the_cpu(cuda):
    """``quantize_int8``'s scale is ``max|g| / 127`` rounded once, as on
    the CPU: at max |g| = 7.682218 the CUDA kernel given the Python
    number 127 multiplies by its rounded reciprocal and lands an ulp off
    (which moved every dequantized value of the tensor). The mean over 3
    replicas divides the same way."""
    from repro_torch.train.compression import (EFState, compressed_psum,
                                               quantize_int8)
    g = torch.linspace(-1.0, 7.682218074798584, 1000)
    q, scale = quantize_int8(g.to(cuda))
    q_h, scale_h = quantize_int8(g)
    assert torch.equal(scale.cpu(), scale_h) and torch.equal(q.cpu(), q_h)
    grads = [{"w": (g * (i + 1)).to(cuda)} for i in range(3)]
    res = [EFState({"w": torch.zeros_like(d["w"])}) for d in grads]
    m_c, _ = compressed_psum(grads, res, "int8")
    m_h, _ = compressed_psum([{"w": d["w"].cpu()} for d in grads],
                             [EFState({"w": torch.zeros(1000)})] * 3, "int8")
    assert all(torch.equal(m_c[r]["w"].cpu(), m_h[r]["w"]) for r in range(3))


def test_collectives_staged_through_pinned_buffers(cuda, tmp_path):
    """Two gloo ranks sharing the card: ``ppermute``, ``all_gather`` and
    ``psum`` of CUDA tensors, staged through pinned host buffers, each
    result back on the card and equal to what was sent (rank 0, which
    receives nothing from the ``ppermute``, gets zeros)."""
    import os
    import sys
    from repro_torch.dist import process
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_c2_ranks as R
    process.spawn(R.card_collectives, 2, str(tmp_path), timeout_s=120)
    res = [torch.load(tmp_path / f"rank{k}.pt") for k in range(2)]
    sent = [torch.arange(4, dtype=torch.bfloat16) + 10 * k for k in range(2)]
    for k, r in enumerate(res):
        assert r["on_card"] and r["device"].startswith("cuda")
        assert torch.equal(r["ppermute"], sent[0] if k == 1
                           else torch.zeros(4, dtype=torch.bfloat16))
        assert all(torch.equal(a, b) for a, b in zip(r["all_gather"], sent))
        assert torch.equal(r["psum"], sent[0].float() + sent[1].float())


# ------------------ kernels and meshes over two cards ------------------

@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 cards; {torch.cuda.device_count()} present")
    return torch.device("cuda:0"), torch.device("cuda:1")


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_on_the_second_card_while_the_first_is_current(two_cards, dtype):
    """K1 (masked) launches on its grid's card, whichever card is current,
    and equals its plain version bit for bit; a mask on the other card is
    refused."""
    first, second = two_cards
    spec = TS.jacobi_2d_5pt()
    u = _grid((70, 300), dtype, second, seed=3)
    mask = torch.zeros(u.shape, dtype=torch.uint8, device=second)
    mask[:5] = 1
    with torch.cuda.device(first):
        got = TE.stencil_temporal(u, spec, t=4, mask=mask)
        torch.cuda.synchronize(second)
        assert got.device == second
        assert torch.cuda.current_device() == first.index
        with pytest.raises(ValueError, match="one card"):
            TE.stencil_temporal(u, spec, t=4, mask=mask.to(first))
    assert torch.equal(got, TE.stencil_temporal_plain(u, spec, t=4,
                                                      mask=mask))


@pytest.mark.parametrize("dtype", DTYPES)
def test_k8_on_the_second_card_while_the_first_is_current(two_cards, dtype):
    from repro_torch.kernels import flash_attention as TF
    first, second = two_cards
    q, k, v = _qkv(2, 256, 8, 2, 128, dtype, second)
    with torch.cuda.device(first):
        got = TF.flash_attention_local(q, k, v, bq=256, bk=256)
        torch.cuda.synchronize(second)
    want = TF.flash_attention_local_plain(q, k, v)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("overlap", [False, True])
def test_mesh_over_two_cards_equals_one_card(two_cards, overlap):
    """A (2,) mesh with one shard a card (the default layout) gives the
    one-card solve bit for bit, overlap on and off."""
    from repro_torch.dist import ShardMesh
    mesh = ShardMesh((2,), ("x",))
    assert mesh.devices == two_cards
    u = TS.make_laplace_problem(62, 254, device=two_cards[0])
    got = TE.run_distributed(u, mesh=mesh, policy="temporal", iters=19, t=4,
                             overlap=overlap)
    assert torch.equal(got, TE.run(u, policy="temporal", iters=19, t=4))
