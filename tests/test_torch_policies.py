"""Each plain policy of the port against the JAX policy in interpret mode.

The JAX side runs its Pallas kernels in interpret mode against the
``cpu_ref`` model, as ``tests/test_engine.py`` does. Tolerances are that
file's: f32 1e-6 for one sweep, rtol 1e-5 / atol 1e-6 for several, bf16
2e-2. On a CPU tensor each port wrapper runs its plain version, so the
wrapper and the plain function agree bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core import stencil as JS
from repro_torch import engine as TE
from repro_torch.core import stencil as TS
from repro_torch.interop import grid_from_numpy, grid_to_numpy

RADIUS2 = ((((-2, 0), (-1, 0), (0, 0), (0, -2), (0, 1)),
            (0.1, 0.3, 0.2, 0.15, 0.25)))
SPECS = {
    "jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
    "laplace9": (JS.laplace_2d_9pt(), TS.laplace_2d_9pt()),
    "advection2d": (JS.advection_2d_3pt(), TS.advection_2d_3pt()),
    "radius2": (JS.StencilSpec(*RADIUS2), TS.StencilSpec(*RADIUS2)),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ONE_SWEEP = ["shifted", "rowchunk", "dbuf"]


def _problem(ny, nx, r, dtype, seed=0):
    """A ringed grid with a fixed ring and noise inside, in both packages."""
    rng = np.random.default_rng(seed)
    a = np.zeros((ny + 2 * r, nx + 2 * r), np.float32)
    a[:, :r] = 1.0
    a[r:-r, r:-r] = rng.uniform(0, 1, (ny, nx))
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), grid_from_numpy(a, device="cpu").to(td)


def _close(ju, tu, dtype, multi=False):
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=1e-5 if multi else 1e-6, atol=1e-6))
    np.testing.assert_allclose(grid_to_numpy(tu.to(torch.float32)),
                               np.asarray(ju.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("policy", ONE_SWEEP)
def test_one_sweep_policy_matches_jax(policy, spec_name, dtype):
    js, ts = SPECS[spec_name]
    ju, tu = _problem(30, 62, ts.radius, dtype, seed=1)
    want = getattr(JE, f"stencil_{policy}")(ju, js, bm=10, interpret=True,
                                            device="cpu_ref")
    plain = getattr(TE, f"stencil_{policy}_plain")(tu, ts, bm=10)
    got = getattr(TE, f"stencil_{policy}")(tu, ts, bm=10, device="cpu_ref")
    assert torch.equal(got, plain) and got.dtype == tu.dtype
    _close(want, got, dtype)
    # The ring is carried through untouched.
    r = ts.radius
    assert torch.equal(got[..., :r, :], tu[..., :r, :])
    assert torch.equal(got[..., :, -r:], tu[..., :, -r:])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_temporal_matches_jax(spec_name, dtype):
    js, ts = SPECS[spec_name]
    ju, tu = _problem(30, 62, ts.radius, dtype, seed=2)
    want = JE.stencil_temporal(ju, js, t=4, bm=10, interpret=True,
                               device="cpu_ref")
    plain = TE.stencil_temporal_plain(tu, ts, t=4)
    got = TE.stencil_temporal(tu, ts, t=4, bm=10, device="cpu_ref")
    assert torch.equal(got, plain)
    _close(want, got, dtype, multi=True)


def test_temporal_plain_is_t_sweeps_rounded_once():
    """In f32 the fused plain version is the oracle applied t times."""
    ts = TS.laplace_2d_9pt()
    _, tu = _problem(30, 62, 1, "float32", seed=3)
    want = tu
    for _ in range(5):
        want = TS.apply_stencil(want, ts)
    assert torch.equal(TE.stencil_temporal_plain(tu, ts, t=5), want)
    # In bf16 it keeps f32 across the sweeps: one rounding, not five.
    _, tb = _problem(30, 62, 1, "bfloat16", seed=3)
    fused = TE.stencil_temporal_plain(tb, ts, t=5)
    f32_then_round = TE.stencil_temporal_plain(tb.float(), ts, t=5).to(
        torch.bfloat16)
    assert torch.equal(fused, f32_then_round)


def test_temporal_mask_equal_to_ring_is_unmasked():
    ts = TS.jacobi_2d_5pt()
    _, tu = _problem(20, 64, 1, "float32", seed=4)
    mask = torch.zeros(tu.shape, dtype=torch.bool)
    mask[:1, :] = mask[-1:, :] = mask[:, :1] = mask[:, -1:] = True
    assert torch.equal(TE.stencil_temporal(tu, ts, t=3, mask=mask),
                       TE.stencil_temporal(tu, ts, t=3))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_temporal_mask_matches_jax_on_its_exact_region(dtype):
    """The distributed-shard pin set of ``tests/test_engine.py``: pinned
    cells hold, perturbed halo cells reach the valid region, and the
    region >= d from any unpinned edge matches the JAX kernel."""
    t, d = 3, 3
    js, ts = SPECS["jacobi5"]
    ju, tu = _problem(22, 64, 1, dtype, seed=5)
    h, w = tu.shape
    mask = np.zeros((h, w), bool)
    mask[:d, :] = mask[:, :d] = True
    tmask = torch.from_numpy(mask)
    got = TE.stencil_temporal(tu, ts, t=t, mask=tmask)
    want = JE.stencil_temporal(ju, js, t=t, interpret=True,
                               device="cpu_ref", mask=jnp.asarray(mask))
    assert torch.equal(got[tmask], tu[tmask])
    tu2 = torch.where(tmask, tu, tu + 0.125)
    got2 = TE.stencil_temporal(tu2, ts, t=t, mask=tmask)
    assert torch.equal(got2[tmask], tu[tmask])
    assert not torch.equal(got2[d:h - d, d:w - d], got[d:h - d, d:w - d])
    _close(want[:h - d, :w - d], got[:h - d, :w - d], dtype, multi=True)
    # f32: equal to the masked-sweep oracle, bit for bit.
    if dtype == "float32":
        oracle = tu
        for _ in range(t):
            oracle = torch.where(tmask, tu, TS.apply_stencil(oracle, ts))
        assert torch.equal(got[:h - d, :w - d], oracle[:h - d, :w - d])


def test_plain_versions_take_a_batch():
    ts = TS.laplace_2d_9pt()
    lanes = [_problem(14, 30, 1, "float32", seed=s)[1] for s in range(3)]
    batch = torch.stack(lanes)
    for name in ONE_SWEEP + ["temporal"]:
        fn = getattr(TE, f"stencil_{name}")
        kw = {"t": 2} if name == "temporal" else {}
        got = fn(batch, ts, **kw)
        for i, lane in enumerate(lanes):
            assert torch.equal(got[i], fn(lane, ts, **kw)), name


def test_out_buffer_receives_the_result():
    ts = TS.jacobi_2d_5pt()
    _, tu = _problem(14, 30, 1, "float32", seed=6)
    out = tu.clone()
    res = TE.stencil_rowchunk(tu, ts, out=out)
    assert res is out and torch.equal(out, TE.stencil_rowchunk(tu, ts))


def test_wrappers_refuse_other_devices():
    ts = TS.jacobi_2d_5pt()
    u = torch.zeros(16, 32, device="meta")
    for name in ONE_SWEEP + ["temporal"]:
        with pytest.raises(ValueError, match="CUDA or CPU"):
            getattr(TE, f"stencil_{name}")(u, ts)


def test_plain_runs_do_not_count_as_launches():
    TE.reset_launch_counts()
    ts = TS.jacobi_2d_5pt()
    _, tu = _problem(14, 30, 1, "float32", seed=7)
    TE.run(tu, ts, iters=5, t=2)
    assert TE.LAUNCHES == {"shifted": 0, "rowchunk": 0, "dbuf": 0,
                           "temporal": 0}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_shifted_views_are_the_plain_shifted_interiors(spec_name, dtype):
    """K4's operands, made apart from its launch: one contiguous shifted
    interior per tap, in tap order, whose f32 weighted sum in that order
    is the plain version's interior bit for bit."""
    _, ts = SPECS[spec_name]
    r = ts.radius
    ju, tu = _problem(13, 29, r, dtype, seed=3)
    tu = torch.stack([tu, tu.flip(-1)])
    a = tu.to(torch.float32).numpy()
    h, w = a.shape[-2:]
    views = TE.shifted_views(tu, ts)
    assert len(views) == ts.taps
    acc = None
    for v, (dy, dx), wt in zip(views, ts.offsets, ts.weights):
        assert v.is_contiguous() and v.dtype == tu.dtype
        np.testing.assert_array_equal(
            v.to(torch.float32).numpy(),
            a[..., r + dy:h - r + dy, r + dx:w - r + dx])
        term = v.to(torch.float32) * TS.f32(wt)
        acc = term if acc is None else acc + term
    plain = TE.stencil_shifted_plain(tu, ts)
    assert torch.equal(acc.to(tu.dtype), plain[..., r:h - r, r:w - r])



class _StubLib:
    """Stands in for the built stencil library: records each launcher's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec_name,variant,geometry", [
    ("jacobi5", "jacobi5", 0), ("laplace9", "laplace9", 1),
    ("radius2", "radius2", 2), ("advection2d", "general", -1)])
@pytest.mark.parametrize("policy", ["rowchunk", "dbuf"])
def test_sweep_launch_arguments(monkeypatch, policy, spec_name, variant,
                                geometry, dtype):
    """K2's and K3's launchers get the spec's geometry code (-1: the
    general kernel), the window pitch and the plan's shared memory, in
    the order and number of their ctypes signatures; each launch counts
    once in LAUNCHES and once under its variant."""
    from repro_torch.engine import policies as P
    from repro_torch.engine.plan import window_pitch
    from repro_torch.kernels.build import SIGNATURES
    lib = _StubLib()
    monkeypatch.setattr(P, "_lib", lambda: lib)
    monkeypatch.setattr(P, "_stream", lambda u: 7)
    ts = SPECS[spec_name][1]
    r = ts.radius
    u = torch.zeros((3, 1024 + 2 * r, 9216 + 2 * r), dtype=dtype)
    plan = TE.plan_for(u.shape[-2:], dtype, ts, policy, device="gpu_sm90")
    TE.reset_launch_counts()
    P._LAUNCHERS[policy](plan, u, u, None)
    (name, args), = lib.calls
    assert name == f"repro_{policy}"
    assert len(args) == len(SIGNATURES["stencil"][name])
    pitch = window_pitch(plan.bn, r, dtype.itemsize)
    head = [geometry, 0 if dtype == torch.float32 else 1, 3, *u.shape[-2:],
            r, plan.bm, plan.bn, plan.row_tiles, plan.col_tiles]
    if policy == "dbuf":
        head.append(0)  # tiles a block: the launcher fills the card
    assert list(args[2:2 + len(head)]) == head
    assert args[2 + len(head)] == pitch and args[3 + len(head)] == ts.taps
    assert args[-2:] == (plan.vmem_bytes, 7)
    counts = getattr(TE, f"{policy.upper()}_VARIANTS")
    assert TE.LAUNCHES[policy] == 1
    assert counts == {k: int(k == variant) for k in counts}
    TE.reset_launch_counts()
    assert set(counts.values()) == {0}
