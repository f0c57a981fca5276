"""The port's Mamba2 block and MambaLM against the JAX package on the CPU.

Inputs and parameters are made with numpy and handed to both packages.
The JAX ``ModelConfig`` has no ``ssm_conv_impl`` field (its ssm layer
reads it with ``getattr``), so :class:`JaxCfg` below declares one; with
``"pallas"`` the JAX side runs its conv kernel (K7) in interpret mode.
Tolerances: f32 compute ``rtol=atol=1e-5``; bf16 compute ``rtol=5e-2,
atol=8e-2`` (the JAX package's flash-vs-jnp bound,
``tests/test_flash_integration.py``), outputs and SSD states alike, since
the two frameworks round bf16 at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.layers import ssm as JS
from repro.models.base import ModelConfig as JaxModelConfig
from repro.models.registry import build_model as jax_build
from repro.models.registry import count_params as jax_count
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.kernels import conv1d as TK
from repro_torch.layers import ssm as TS
from repro_torch.models.base import ParamInit
from repro_torch.models.registry import build_model, count_params
from repro_torch.models.ssm_lm import MambaLM

ARCH = "mamba2-2.7b"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=8e-2)}


@dataclasses.dataclass(frozen=True)
class JaxCfg(JaxModelConfig):
    """The JAX config with the conv switch its ssm layer reads."""
    ssm_conv_impl: str = "jnp"

@pytest.fixture(autouse=True)
def _forward_without_grad():
    """These tests hold the forward (serving) path, which runs under
    ``torch.no_grad()`` as ``ServeEngine`` does: parameters require grad
    by default, and K8 and K7 refuse a gradient. Training is held in
    ``tests/test_torch_train.py``."""
    with torch.no_grad():
        yield


def _cfgs(dname="float32", impl="jnp", **kw):
    jdt, tdt = DT[dname]
    jc = JC.get_smoke_config(ARCH)
    jcfg = JaxCfg(**{f.name: getattr(jc, f.name)
                     for f in dataclasses.fields(jc)})
    return (dataclasses.replace(jcfg, dtype=jdt, ssm_conv_impl=impl, **kw),
            dataclasses.replace(TC.get_smoke_config(ARCH), dtype=tdt,
                                ssm_conv_impl=impl, **kw))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def _rand(rng, *shape, scale=1.0):
    return rng.standard_normal(shape, dtype=np.float32) * scale


def _both(a, dname):
    jdt, tdt = DT[dname]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _ssm_tree(rng, cfg):
    d, di, h, k = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_conv
    cd = TS.conv_dim(cfg)
    return {"z_proj": _rand(rng, d, di, scale=d ** -0.5),
            "xbc_proj": _rand(rng, d, cd, scale=d ** -0.5),
            "dt_proj": _rand(rng, d, h, scale=d ** -0.5),
            "conv_w": _rand(rng, k, cd, scale=0.5),
            "conv_b": _rand(rng, cd, scale=0.1),
            "A_log": np.log(np.linspace(0.5, 4.0, h)).astype(np.float32),
            "D": 1.0 + _rand(rng, h, scale=0.1),
            "dt_bias": _rand(rng, h, scale=0.5),
            "norm_scale": 1.0 + _rand(rng, di, scale=0.1),
            "out_proj": _rand(rng, di, d, scale=di ** -0.5)}


def _ssm_pair(tcfg, seed):
    rng = np.random.default_rng(seed)
    tree = _ssm_tree(rng, tcfg)
    init = ParamInit(tcfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    p = interop.load_params(TS.SSM(init, tcfg), tree)
    return jax.tree.map(jnp.asarray, tree), p, rng


# ----------------------------- SSD scan -----------------------------

@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("dname", list(DT))
def test_ssd_scan(dname, chunk):
    """Two groups; chunk 16 gives four chunks (the inter-chunk loop), 64
    one."""
    rng = np.random.default_rng(10)
    b, l, g, m, p, n = 2, 64, 2, 3, 8, 16
    x = _rand(rng, b, l, g, m, p)
    dt = np.log1p(np.exp(_rand(rng, b, l, g, m, scale=0.5) - 1.0))
    a = -np.exp(_rand(rng, g, m, scale=0.5))
    bm, cm = _rand(rng, b, l, g, n, scale=0.25), _rand(rng, b, l, g, n,
                                                       scale=0.25)
    jdt, tdt = DT[dname]
    jx, tx = _both(x, dname)
    jb, tb = _both(bm, dname)
    jc, tc = _both(cm, dname)
    want_y, want_s = JS.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(a), jb,
                                 jc, chunk, jdt)
    got_y, got_s = TS.ssd_scan(tx, torch.from_numpy(dt),
                               torch.from_numpy(a), tb, tc, chunk, tdt)
    assert got_y.dtype == tdt and got_s.dtype == torch.float32
    assert got_s.shape == (b, g, m, p, n)
    _close(got_y, want_y, TOL[dname])
    _close(got_s, want_s, TOL[dname])


def test_chunk_precondition_raises():
    _, tcfg = _cfgs()
    x = torch.zeros((1, 24, 1, 2, 4))
    with pytest.raises(ValueError, match="l % min"):
        TS.ssd_scan(x, torch.ones((1, 24, 1, 2)), -torch.ones((1, 2)),
                    torch.zeros((1, 24, 1, 8)), torch.zeros((1, 24, 1, 8)),
                    16, torch.float32)
    _, p, _ = _ssm_pair(tcfg, 0)
    with pytest.raises(ValueError, match="l % min"):
        TS.ssm_block(p, torch.zeros((1, 24, tcfg.d_model)), tcfg)


# ----------------------------- the block -----------------------------

@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("dname", list(DT))
def test_ssm_block_without_cache(dname, impl):
    jcfg, tcfg = _cfgs(dname, impl)
    jp, p, rng = _ssm_pair(tcfg, 11)
    jx, tx = _both(_rand(rng, 2, 32, tcfg.d_model), dname)
    want, _ = JS.ssm_block(jp, jx, jcfg)
    got, none = TS.ssm_block(p, tx, tcfg)
    assert none is None and got.dtype == tx.dtype
    _close(got, want, TOL[dname])


@pytest.mark.parametrize("dname", list(DT))
def test_ssm_block_prefill_then_decode_steps(dname):
    """Prefill with a cache returns the final state and the last K-1
    pre-conv inputs; each decode step updates both."""
    jcfg, tcfg = _cfgs(dname, "pallas")
    jp, p, rng = _ssm_pair(tcfg, 12)
    b = 2
    jx, tx = _both(_rand(rng, b, 48, tcfg.d_model), dname)
    jcache = JS.init_ssm_cache(jcfg, b)
    tcache = TS.init_ssm_cache(tcfg, b, device="cpu")
    assert tcache.state.shape == jcache.state.shape
    assert tcache.conv.shape == jcache.conv.shape
    assert tcache.conv.dtype == DT[dname][1]
    want, jcache = JS.ssm_block(jp, jx, jcfg, jcache)
    got, tcache = TS.ssm_block(p, tx, tcfg, tcache)
    _close(got, want, TOL[dname])
    _close(tcache.state, jcache.state, TOL[dname])
    _close(tcache.conv, jcache.conv, TOL[dname])
    for _ in range(3):
        jx1, tx1 = _both(_rand(rng, b, 1, tcfg.d_model), dname)
        want, jcache = JS.ssm_block(jp, jx1, jcfg, jcache)
        got, tcache = TS.ssm_block(p, tx1, tcfg, tcache)
        _close(got, want, TOL[dname])
        _close(tcache.state, jcache.state, TOL[dname])
        _close(tcache.conv, jcache.conv, TOL[dname])


def test_decode_step_alone():
    """``_ssm_decode_step`` on a carried-over cache (f32 conv weights over
    an f32-widened window)."""
    jcfg, tcfg = _cfgs()
    jp, p, rng = _ssm_pair(tcfg, 13)
    b, h, cd = 2, tcfg.ssm_heads, TS.conv_dim(tcfg)
    state = _rand(rng, b, 1, h, tcfg.ssm_head_dim, tcfg.ssm_state)
    conv = _rand(rng, b, tcfg.ssm_conv - 1, cd)
    z = _rand(rng, b, 1, tcfg.d_inner)
    xbc = _rand(rng, b, 1, cd)
    dt_raw = _rand(rng, b, 1, h)
    want, jc = JS._ssm_decode_step(
        jp, *map(jnp.asarray, (z, xbc, dt_raw)), jcfg,
        JS.SSMCache(jnp.asarray(state), jnp.asarray(conv)))
    got, tc = TS._ssm_decode_step(
        p, *map(torch.from_numpy, (z, xbc, dt_raw)), tcfg,
        TS.SSMCache(torch.from_numpy(state), torch.from_numpy(conv)))
    _close(got, want, TOL["float32"])
    _close(tc.state, jc.state, TOL["float32"])
    _close(tc.conv, jc.conv, TOL["float32"])


def test_a_prompt_shorter_than_the_conv_leaves_a_zero_led_tail():
    """The reference keeps only l < K-1 rows then (and its decode step
    fails); the port keeps K-1, led by the conv's zeros."""
    _, tcfg = _cfgs()
    _, p, rng = _ssm_pair(tcfg, 14)
    x = torch.from_numpy(_rand(rng, 2, 2, tcfg.d_model))
    _, cache = TS.ssm_block(p, x, tcfg, TS.init_ssm_cache(tcfg, 2,
                                                         device="cpu"))
    assert cache.conv.shape == (2, tcfg.ssm_conv - 1, TS.conv_dim(tcfg))
    assert float(cache.conv[:, 0].abs().max()) == 0.0
    torch.testing.assert_close(cache.conv[:, 1:],
                               x @ p.xbc_proj.to(torch.float32))


# ----------------------------- the model -----------------------------

def _models(jcfg, tcfg, seed=0):
    jmodel = jax_build(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    return jmodel, params, tmodel


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("dname", list(DT))
def test_mamba_forward_logits(dname, impl):
    jcfg, tcfg = _cfgs(dname, impl)
    jmodel, params, tmodel = _models(jcfg, tcfg)
    assert isinstance(tmodel, MambaLM)
    toks = np.random.default_rng(15).integers(0, tcfg.vocab_size, (2, 64))
    want, _, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    got, cache, aux = tmodel.forward({"tokens": torch.from_numpy(toks)})
    assert cache is None and aux == {}
    assert got.shape == (2, 64, tcfg.padded_vocab)
    assert got.dtype == torch.float32
    _close(got, want, TOL[dname])


@pytest.mark.parametrize("dname", list(DT))
def test_mamba_prefill_and_decode_with_cache(dname):
    jcfg, tcfg = _cfgs(dname, "pallas")
    jmodel, params, tmodel = _models(jcfg, tcfg, seed=1)
    toks = np.random.default_rng(16).integers(0, tcfg.vocab_size, (2, 36))
    jcache = jmodel.init_cache(2, 40)
    tcache = tmodel.init_cache(2, 40)
    assert tcache.state.shape == jcache.state.shape
    assert tcache.conv.shape == jcache.conv.shape
    want, jcache, _ = jmodel.forward(
        params, {"tokens": jnp.asarray(toks[:, :32])}, jcache,
        last_only=True)
    got, same, _ = tmodel.forward({"tokens": torch.from_numpy(toks[:, :32])},
                                  tcache, last_only=True)
    assert same is tcache and got.shape == (2, 1, tcfg.padded_vocab)
    _close(got, want, TOL[dname])
    _close(tcache.state, jcache.state, TOL[dname])
    for t in range(32, 36):
        step = toks[:, t:t + 1]
        want, jcache, _ = jmodel.forward(params,
                                         {"tokens": jnp.asarray(step)},
                                         jcache)
        got, tcache, _ = tmodel.forward({"tokens": torch.from_numpy(step)},
                                        tcache)
        _close(got, want, TOL[dname])
    _close(tcache.state, jcache.state, TOL[dname])
    _close(tcache.conv, jcache.conv, TOL[dname])


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_prefill_decode_matches_full_forward(impl):
    """The JAX package's own check (``tests/test_archs_smoke.py``), on the
    port, in the smoke config's bf16 compute."""
    _, tcfg = _cfgs("bfloat16", impl)
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 16)))
    full, _, _ = model.forward({"tokens": toks})
    cache = model.init_cache(2, max_len=24)
    pre, cache, _ = model.forward({"tokens": toks[:, :-1]}, cache)
    step, cache, _ = model.forward({"tokens": toks[:, -1:]}, cache)
    tol = dict(rtol=0.1, atol=0.15)
    torch.testing.assert_close(step[:, 0], full[:, -1], **tol)
    torch.testing.assert_close(pre[:, 5], full[:, 5], **tol)


def test_conv_routes_agree_and_only_a_card_counts_launches():
    _, tcfg = _cfgs("bfloat16", "pallas")
    model = build_model(tcfg, device="cpu")
    plain = model.with_config(dataclasses.replace(tcfg, ssm_conv_impl="jnp"))
    assert plain.layers is model.layers and model.cfg.ssm_conv_impl == "pallas"
    toks = torch.arange(32)[None] % tcfg.vocab_size
    TK.reset_launch_counts()
    a, _, _ = model.forward({"tokens": toks})
    b, _, _ = plain.forward({"tokens": toks})
    assert torch.equal(a, b) and TK.LAUNCHES["conv1d"] == 0
    with pytest.raises(ValueError, match="execution knobs"):
        model.with_config(dataclasses.replace(tcfg, ssm_state=8))


@pytest.mark.parametrize("get", ["get_smoke_config", "get_config"])
def test_count_params_matches_jax(get):
    want = jax_count(getattr(JC, get)(ARCH))
    cfg = getattr(TC, get)(ARCH)
    assert count_params(cfg) == want == cfg.n_params()


def test_init_rule_shapes_and_scales():
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    assert all(p.requires_grad for p in model.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    h, cd = tcfg.ssm_heads, TS.conv_dim(tcfg)
    ssm = model.layers[1].ssm
    torch.testing.assert_close(ssm.A_log, torch.from_numpy(np.log(
        np.linspace(0.5, 4.0, h)).astype(np.float32)))
    assert float(ssm.D.min()) == float(ssm.D.max()) == 1.0
    assert float(ssm.dt_bias.abs().max()) == 0.0
    assert float(ssm.conv_b.abs().max()) == 0.0
    assert float(ssm.norm_scale.min()) == 1.0
    assert ssm.conv_w.shape == (tcfg.ssm_conv, cd)
    assert abs(float(ssm.conv_w.std()) - 0.5) < 0.05
    assert abs(float(ssm.z_proj.std()) - tcfg.d_model ** -0.5) < 0.02
    assert model.embedding.head.shape == (tcfg.d_model, tcfg.padded_vocab)
    names = {n.split(".", 3)[-1] for n, _ in model.named_parameters()
             if n.startswith("layers.0.ssm.")}
    assert names == {"z_proj", "xbc_proj", "dt_proj", "conv_w", "conv_b",
                     "A_log", "D", "dt_bias", "norm_scale", "out_proj"}
    again = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.layers[1].ssm.out_proj, ssm.out_proj)
