"""The port's HybridLM (zamba2) against the JAX package on the CPU.

Smoke size: 7 mamba layers at period 3, so two groups, each behind one
application of the shared block, and a one-layer tail. Parameters come
from the JAX init and cross through ``interop.lm_params_from_jax``; tokens
are made with numpy. The JAX ``ModelConfig`` has no ``ssm_conv_impl``
field (its ssm layer reads it with ``getattr``), so :class:`JaxCfg`
declares one; with ``"pallas"`` the JAX side runs its conv kernel (K7),
and with ``attn_impl="flash"`` its flash kernel (K8), in interpret mode.

Tolerances. Each stage (the embedding, every application of the shared
block, every mamba layer, the final norm and head), fed the JAX model's
own input to that stage, is held to the port's usual bounds: f32 compute
``rtol=atol=1e-5``; bf16 compute ``rtol=5e-2, atol=8e-2`` (the JAX
package's flash-vs-jnp bound, ``tests/test_flash_integration.py``). Over
the whole 9-stage model the two packages' roundings compound, and these
bounds do not hold:

- f32: the logits and caches are held to ``rtol=1e-5, atol=5e-5``. The
  largest excess over ``1e-5 * |jax|`` read 0.77e-5 to 3.37e-5 across
  the logits of the whole-model tests below (the most at the fourth
  decode step), with 1, 3 and 8 CPU threads.
- bf16: the largest |port - JAX| is held to half the JAX model's own
  bf16-vs-f32 gap on the same tokens. The ratio read 0.16 to 0.44
  (0.44 on the flash long path; |port - JAX| 0.078 to 0.219, the JAX
  gap 0.19 to 0.64), the same with 1, 3 and 8 threads. A port that
  computed in f32 would sit near 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.layers import basic as JB
from repro.layers import ssm as JS
from repro.models.base import ModelConfig as JaxModelConfig
from repro.models.registry import build_model as jax_build
from repro.models.registry import count_params as jax_count
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.kernels import conv1d as TK
from repro_torch.kernels import flash_attention as TF
from repro_torch.layers import basic as TB
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.registry import build_model, count_params

ARCH = "zamba2-7b"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=8e-2)}
MODEL_TOL_F32 = dict(rtol=1e-5, atol=5e-5)
#: the bf16 whole-model bound, a share of the JAX bf16-vs-f32 gap
MODEL_SHARE_BF16 = 0.5


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


def _cfgs(dname="float32", **kw):
    jdt, tdt = DT[dname]
    jc = JC.get_smoke_config(ARCH)
    jcfg = JaxCfg(**{f.name: getattr(jc, f.name)
                     for f in dataclasses.fields(jc)})
    return (dataclasses.replace(jcfg, dtype=jdt, **kw),
            dataclasses.replace(TC.get_smoke_config(ARCH), dtype=tdt, **kw))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dname):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dname])


def _close_model(got, want, dname, want_f32):
    """Whole-model outputs (see the module note): ``want_f32`` is the JAX
    model's in f32 compute, the yardstick of bf16's own error."""
    if dname == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL_F32)
        return
    gap = float(np.abs(got.float().numpy() - _np(want)).max())
    noise = float(np.abs(_np(want) - _np(want_f32)).max())
    assert gap <= MODEL_SHARE_BF16 * noise, (
        f"port vs JAX in bf16 {gap} > {MODEL_SHARE_BF16} x JAX bf16 vs f32 "
        f"{noise}")


def _torch(a, dtype):
    return torch.from_numpy(_np(a)).to(dtype)


def _models(jcfg, tcfg, seed=0):
    jmodel = jax_build(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    return jmodel, params, tmodel


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_smoke_config_shapes_the_groups():
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu")
    assert isinstance(model, HybridLM)
    assert (model.n_groups, model.n_tail) == (2, 1)
    assert [len(g) for g in model.groups] == [3, 3] and len(model.tail) == 1
    full = TC.get_config(ARCH)
    assert (full.n_layers // full.hybrid_period,
            full.n_layers % full.hybrid_period) == (13, 3)
    assert full.hd == 112 and full.n_heads == full.n_kv_heads == 32


VARIANTS = {"jnp": dict(ssm_conv_impl="jnp"),
            "pallas": dict(ssm_conv_impl="pallas"),
            "flash": dict(ssm_conv_impl="pallas", attn_impl="flash",
                          attn_chunk=16)}


def _jax_mamba(lp, x, jcfg):
    h, _ = JS.ssm_block(lp["ssm"], JB.rms_norm(lp["ln"], x, jcfg.norm_eps),
                        jcfg)
    return x + h


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dname", list(DT))
def test_each_stage_matches_jax(dname, variant):
    """Every stage of a 32-token forward on the JAX model's input to it:
    the embedding, the shared block at both applications (through K8's
    long path with ``flash``), the seven mamba layers (through K7 with
    ``pallas`` and ``flash``), and the final norm and head."""
    jcfg, tcfg = _cfgs(dname, **VARIANTS[variant])
    jmodel, params, tmodel = _models(jcfg, tcfg, seed=4)
    tdt = DT[dname][1]
    toks = _tokens(23, (2, 32))
    emb = JB.embed(params, jnp.asarray(toks), jcfg)
    emb_t = TB.embed(tmodel.embedding, torch.from_numpy(toks), tcfg)
    _close(emb_t, emb, dname)
    pos = jnp.broadcast_to(jnp.arange(32, dtype=jnp.int32)[None], (2, 32))
    pos_t = torch.arange(32).expand(2, 32)
    x = emb
    for g in range(tmodel.n_groups):
        want, _ = jmodel._shared(params, x, emb, pos, None)
        _close(tmodel.shared_block(_torch(x, tdt), emb_t, pos_t, None), want,
               dname)
        x = want
        for i in range(tcfg.hybrid_period):
            want = _jax_mamba(jax.tree.map(lambda a: a[g, i],
                                           params["groups"]), x, jcfg)
            _close(tmodel.mamba_layer(tmodel.groups[g][i], _torch(x, tdt)),
                   want, dname)
            x = want
    for i in range(tmodel.n_tail):
        want = _jax_mamba(jax.tree.map(lambda a: a[i], params["tail"]), x,
                          jcfg)
        _close(tmodel.mamba_layer(tmodel.tail[i], _torch(x, tdt)), want,
               dname)
        x = want
    want = JB.unembed(params, JB.rms_norm(params["ln_f"], x, jcfg.norm_eps),
                      jcfg)
    got = TB.unembed(tmodel.embedding, TB.rms_norm(
        tmodel.ln_f, _torch(x, tdt), tcfg.norm_eps), tcfg)
    _close(got, want, dname)


def _jax_f32(jcfg):
    return jax_build(dataclasses.replace(jcfg, dtype=jnp.float32))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("dname", list(DT))
def test_hybrid_forward_logits(dname, impl):
    jcfg, tcfg = _cfgs(dname, ssm_conv_impl=impl)
    jmodel, params, tmodel = _models(jcfg, tcfg)
    toks = _tokens(20, (2, 32))
    want, _, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    want32, _, _ = _jax_f32(jcfg).forward(params,
                                          {"tokens": jnp.asarray(toks)})
    got, cache, aux = tmodel.forward({"tokens": torch.from_numpy(toks)})
    assert cache is None and aux == {}
    assert got.shape == (2, 32, tcfg.padded_vocab)
    assert got.dtype == torch.float32
    _close_model(got, want, dname, want32)


def _close_cache(tcache, jcache):
    """f32 caches, to the whole model's f32 bound."""
    assert tcache["kv"].length == int(jcache["kv"].length[0])
    n = tcache["kv"].length
    pairs = [(getattr(tcache["kv"], name)[:, :, :n],  # the written part
              getattr(jcache["kv"], name)[:, :, :n]) for name in ("k", "v")]
    pairs += [(getattr(tcache[key], f), getattr(jcache[key], f))
              for key in ("ssm_groups", "ssm_tail") for f in ("state", "conv")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL_F32)


def _serve_steps(model, params, toks, cache, last_only=True):
    """JAX logits of a 32-token prefill into ``cache`` and one decode step
    a further token."""
    out = []
    logits, cache, _ = model.forward(params, {"tokens": jnp.asarray(
        toks[:, :32])}, cache, last_only=last_only)
    out.append(logits)
    for t in range(32, toks.shape[1]):
        logits, cache, _ = model.forward(
            params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, cache)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("dname", list(DT))
def test_hybrid_prefill_and_decode_with_cache(dname):
    """Prefill 32 tokens into the cache (the shared block's short path),
    then 4 decode steps: the logits of each, and in f32 every KV cache and
    every SSM state and conv tail."""
    jcfg, tcfg = _cfgs(dname, ssm_conv_impl="pallas")
    jmodel, params, tmodel = _models(jcfg, tcfg, seed=1)
    toks = _tokens(21, (2, 36))
    jcache = jmodel.init_cache(2, 40)
    tcache = tmodel.init_cache(2, 40)
    assert set(tcache) == set(jcache) == {"kv", "ssm_groups", "ssm_tail"}
    for key in ("ssm_groups", "ssm_tail"):
        assert tcache[key].state.shape == jcache[key].state.shape
        assert tcache[key].conv.shape == jcache[key].conv.shape
    assert tcache["kv"].k.shape == jcache["kv"].k.shape == (2, 2, 40, 4, 16)
    assert tcache["kv"].k.data_ptr() != tcache["kv"].v.data_ptr()
    want, jcache = _serve_steps(jmodel, params, toks, jcache)
    want32, _ = _serve_steps(_jax_f32(jcfg), params, toks,
                             _jax_f32(jcfg).init_cache(2, 40))
    got, tcache, _ = tmodel.forward({"tokens": torch.from_numpy(
        toks[:, :32])}, tcache, last_only=True)
    assert got.shape == (2, 1, tcfg.padded_vocab)
    _close_model(got, want[0], dname, want32[0])
    for j, t in enumerate(range(32, 36)):
        got, tcache, _ = tmodel.forward({"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, tcache)
        _close_model(got, want[j + 1], dname, want32[j + 1])
    if dname == "float32":
        _close_cache(tcache, jcache)


@pytest.mark.parametrize("dname", list(DT))
def test_hybrid_flash_long_path(dname):
    """``attn_impl="flash"`` with ``attn_chunk`` 16: a 32-token prompt
    takes the long path, through K8 (its plain version here, the Pallas
    kernel in interpret mode there), with and without a cache."""
    jcfg, tcfg = _cfgs(dname, **VARIANTS["flash"])
    jmodel, params, tmodel = _models(jcfg, tcfg, seed=2)
    j32 = _jax_f32(jcfg)
    toks = _tokens(22, (2, 33))
    batch = {"tokens": jnp.asarray(toks[:, :32])}
    want, _, _ = jmodel.forward(params, batch)
    want32, _, _ = j32.forward(params, batch)
    TF.reset_launch_counts()
    got, _, _ = tmodel.forward({"tokens": torch.from_numpy(toks[:, :32])})
    assert TF.LAUNCHES["flash_attention"] == 0  # plain version on the CPU
    _close_model(got, want, dname, want32)
    jcache, tcache = jmodel.init_cache(2, 40), tmodel.init_cache(2, 40)
    want, jcache = _serve_steps(jmodel, params, toks, jcache)
    want32, _ = _serve_steps(j32, params, toks, j32.init_cache(2, 40))
    got, tcache, _ = tmodel.forward({"tokens": torch.from_numpy(
        toks[:, :32])}, tcache, last_only=True)
    _close_model(got, want[0], dname, want32[0])
    got, tcache, _ = tmodel.forward({"tokens": torch.from_numpy(
        toks[:, 32:])}, tcache)
    _close_model(got, want[1], dname, want32[1])
    if dname == "float32":
        _close_cache(tcache, jcache)


def test_prefill_decode_matches_full_forward():
    """The JAX package's own check (``tests/test_archs_smoke.py``), on the
    port, in the smoke config's bf16 compute."""
    _, tcfg = _cfgs("bfloat16", ssm_conv_impl="pallas")
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(3, (2, 16)))
    full, _, _ = model.forward({"tokens": toks})
    cache = model.init_cache(2, max_len=24)
    pre, cache, _ = model.forward({"tokens": toks[:, :-1]}, cache)
    assert cache["kv"].length == 15
    step, cache, _ = model.forward({"tokens": toks[:, -1:]}, cache)
    assert cache["kv"].length == 16
    tol = dict(rtol=0.1, atol=0.15)
    torch.testing.assert_close(step[:, 0], full[:, -1], **tol)
    torch.testing.assert_close(pre[:, 5], full[:, 5], **tol)


def test_a_cache_passed_twice_is_written_at_the_same_place():
    """The returned cache carries the advanced length; the one passed in
    keeps its own, so a decode step can be repeated on it (as timing does)."""
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu")
    cache = model.init_cache(1, 8)
    toks = torch.from_numpy(_tokens(4, (1, 4)))
    _, new, _ = model.forward({"tokens": toks}, cache)
    assert cache["kv"].length == 0 and new["kv"].length == 4
    assert new["kv"].k is cache["kv"].k
    assert new["ssm_groups"] is cache["ssm_groups"]
    _, again, _ = model.forward({"tokens": toks}, cache)
    assert again["kv"].length == 4


def test_with_config_shares_parameters_and_routes_agree():
    _, tcfg = _cfgs("bfloat16", ssm_conv_impl="pallas")
    model = build_model(tcfg, device="cpu")
    plain = model.with_config(dataclasses.replace(tcfg, ssm_conv_impl="jnp"))
    assert plain.groups is model.groups and plain.shared_attn is \
        model.shared_attn and model.cfg.ssm_conv_impl == "pallas"
    toks = torch.from_numpy(_tokens(5, (2, 32)))
    TK.reset_launch_counts()
    a, _, _ = model.forward({"tokens": toks})
    b, _, _ = plain.forward({"tokens": toks})
    assert torch.equal(a, b) and TK.LAUNCHES["conv1d"] == 0
    with pytest.raises(ValueError, match="execution knobs"):
        model.with_config(dataclasses.replace(tcfg, hybrid_period=2))


@pytest.mark.parametrize("get", ["get_smoke_config", "get_config"])
def test_count_params_matches_jax(get):
    want = jax_count(getattr(JC, get)(ARCH))
    cfg = getattr(TC, get)(ARCH)
    assert count_params(cfg) == want == cfg.n_params()


def test_full_size_parameter_budget():
    """81 mamba layers, one shared block over 2d, an untied embedding and
    head: about 6.9 B parameters (27.6 GB in f32)."""
    cfg = TC.get_config(ARCH)
    model = build_model(cfg, device="meta")
    n = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    shared = sum(n(getattr(model, f"shared_{x}"))
                 for x in ("ln1", "attn", "ln2", "ffn"))
    assert len(list(model.groups)) * cfg.hybrid_period + len(model.tail) == 81
    assert abs(n(model.tail[0]) / 77.9e6 - 1) < 0.01
    assert abs(shared / 347e6 - 1) < 0.01
    assert abs(n(model.embedding) / 229.4e6 - 1) < 0.01
    assert abs(n(model) / 6.9e9 - 1) < 0.02


def test_lm_params_from_jax_carries_and_checks_the_hybrid_tree():
    jcfg, tcfg = _cfgs()
    _, params, tmodel = _models(jcfg, tcfg, seed=3)
    tree = jax.tree.map(np.asarray, params)
    assert tree["groups"]["ssm"]["out_proj"].shape[:2] == (2, 3)
    np.testing.assert_array_equal(tmodel.groups[1][2].ssm.out_proj.numpy(),
                                  tree["groups"]["ssm"]["out_proj"][1, 2])
    np.testing.assert_array_equal(tmodel.tail[0].ln.scale.numpy(),
                                  tree["tail"]["ln"]["scale"][0])
    np.testing.assert_array_equal(tmodel.shared_attn.wq.numpy(),
                                  tree["shared_attn"]["wq"])
    np.testing.assert_array_equal(tmodel.shared_ffn.down.numpy(),
                                  tree["shared_ffn"]["down"])
    del tree["tail"]
    with pytest.raises(KeyError, match="missing"):
        interop.lm_params_from_jax(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unknown"):
        interop.lm_params_from_jax(tree, tcfg, device="cpu")
    with pytest.raises(ValueError, match="n_groups"):
        interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                   dataclasses.replace(tcfg, n_layers=10),
                                   device="cpu")


def test_mla_is_refused():
    cfg = TC.get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="GQA"):
        HybridLM(dataclasses.replace(cfg, attn_type="mla"), device="cpu")


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(TC.get_smoke_config(ARCH))


def test_reference_routes_agree_in_f32_not_in_bf16():
    """The JAX package's own hybrid, flash route against jnp route (its
    Pallas kernel in interpret mode, ``attn_chunk`` 16, S=32): within
    1e-4 in f32, but in bf16 past the rtol 5e-2 / atol 8e-2 bound that the
    dense model's routes meet, by as much as bf16 is from f32. The card's
    check of zamba2's whole bf16 prefill against the jnp route
    (``chip_smoke.py`` phase 11) fails the same way."""
    logits = {}
    for impl in ("jnp", "flash"):
        for dname in DT:
            jcfg, _ = _cfgs(dname, attn_impl=impl, attn_chunk=16,
                            ssm_conv_impl="pallas")
            model = jax_build(jcfg)
            params, _ = model.init(jax.random.PRNGKey(0))
            logits[impl, dname] = _np(model.forward(
                params, {"tokens": jnp.asarray(_tokens(20, (2, 32)))})[0])

    def excess(a, b):
        return float((np.abs(a - b) - 5e-2 * np.abs(b)).max())

    f32 = np.abs(logits["flash", "float32"] - logits["jnp", "float32"])
    assert float(f32.max()) < 1e-4
    routes = excess(logits["flash", "bfloat16"], logits["jnp", "bfloat16"])
    rounding = excess(logits["jnp", "bfloat16"], logits["jnp", "float32"])
    assert routes > 8e-2 and rounding > 8e-2
