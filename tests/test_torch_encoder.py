"""The port's encoder (hubert) and its layers against the JAX package on
the CPU.

Inputs and parameters are made with numpy and handed to both packages;
the JAX flash path runs its Pallas kernel in interpret mode. Tolerances:
f32 compute ``rtol=atol=1e-5``; bf16 compute ``rtol=5e-2, atol=8e-2``
(the JAX package's flash-vs-jnp bound), since the frameworks round bf16
at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.layers import basic as JB
from repro.models.registry import build_model as jax_build
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.kernels import flash_attention as TF
from repro_torch.layers import basic as TB
from repro_torch.models.base import ParamInit
from repro_torch.models.encoder import EncoderModel

ARCH = "hubert-xlarge"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=8e-2)}


def _cfgs(dname="float32", **kw):
    jdt, tdt = DT[dname]
    return (dataclasses.replace(JC.get_smoke_config(ARCH), dtype=jdt, **kw),
            dataclasses.replace(TC.get_smoke_config(ARCH), dtype=tdt, **kw))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dname):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dname])


def _both(a, dname):
    jdt, tdt = DT[dname]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("dname", list(DT))
def test_layer_norm(dname):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    tree = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    _, tcfg = _cfgs(dname)
    p = interop.load_params(TB.LayerNorm(ParamInit(tcfg, device="cpu"), 64),
                            tree)
    jx, tx = _both(x, dname)
    with torch.no_grad():
        got = TB.layer_norm(p, tx, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, JB.layer_norm(jax.tree.map(jnp.asarray, tree), jx, 1e-5),
           dname)


@pytest.mark.parametrize("dname", list(DT))
def test_gelu_mlp(dname):
    """The reference's ``jax.nn.gelu`` is the tanh approximation."""
    jcfg, tcfg = _cfgs(dname)
    rng = np.random.default_rng(1)
    tree = {"up": (rng.standard_normal((64, 128)) / 8).astype(np.float32),
            "up_b": (0.1 * rng.standard_normal(128)).astype(np.float32),
            "down": (rng.standard_normal((128, 64)) / 11).astype(np.float32),
            "down_b": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    p = interop.load_params(TB.GeluMLP(ParamInit(tcfg, device="cpu"), 64,
                                       128), tree)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jx, tx = _both(x, dname)
    with torch.no_grad():
        got = TB.gelu_mlp(p, tx, tcfg)
    _close(got, JB.gelu_mlp(jax.tree.map(jnp.asarray, tree), jx, jcfg),
           dname)


def _models(dname, **kw):
    jcfg, tcfg = _cfgs(dname, **kw)
    jmodel = jax_build(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    tmodel = interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    return jcfg, tcfg, jmodel, params, tmodel


def _features(tcfg, seed=2, b=2, s=64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, tcfg.audio_feat_dim)).astype(
        np.float32)


@pytest.mark.parametrize("impl", ["jnp", "flash"])
@pytest.mark.parametrize("dname", list(DT))
def test_encoder_forward_logits(dname, impl):
    """64 frames over ``attn_chunk`` 16: the long path, non-causal; with
    ``flash`` the JAX side runs its kernel in interpret mode and the
    port's K8 wrapper its plain version on the CPU."""
    jcfg, tcfg, jmodel, params, tmodel = _models(dname, attn_chunk=16,
                                                 attn_impl=impl)
    feats = _features(tcfg)
    jf, tf = _both(feats, dname)
    want, _, _ = jmodel.forward(params, {"features": jf})
    with torch.no_grad():
        got, cache, aux = tmodel.forward({"features": tf})
    assert cache is None and aux == {}
    assert got.dtype == torch.float32
    assert got.shape == (2, 64, tcfg.padded_vocab)
    _close(got, want, dname)


def test_encoder_attends_both_ways():
    """Non-causal: a change to the last frame moves the first frame's
    logits."""
    _, tcfg, _, _, tmodel = _models("float32")
    feats = torch.from_numpy(_features(tcfg))
    with torch.no_grad():
        a, _, _ = tmodel.forward({"features": feats})
        feats[:, -1] += 1.0
        b, _, _ = tmodel.forward({"features": feats})
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


def test_flash_and_jnp_routes_agree_and_refuse_grad_on_flash():
    _, tcfg, _, _, tmodel = _models("float32", attn_chunk=16)
    flash = tmodel.with_config(dataclasses.replace(tcfg, attn_impl="flash"))
    feats = {"features": torch.from_numpy(_features(tcfg))}
    with torch.no_grad():
        a, _, _ = tmodel.forward(feats)
        b, _, _ = flash.forward(feats)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(TF.GradientError):
        flash.forward(feats)
    with pytest.raises(ValueError, match="execution knobs"):
        tmodel.with_config(dataclasses.replace(tcfg, d_model=32))


def test_encoder_refuses_a_cache_and_a_causal_config():
    _, tcfg, _, _, tmodel = _models("float32")
    with pytest.raises(ValueError, match="decode"):
        tmodel.forward({"features": torch.zeros(1, 4, tcfg.audio_feat_dim)},
                       cache=object())
    with pytest.raises(ValueError, match="non-causal"):
        EncoderModel(dataclasses.replace(tcfg, causal=True), device="cpu")


def test_encoder_tree_crosses_name_for_name():
    jcfg, tcfg, _, params, tmodel = _models("float32")
    flat = interop.port_names(jax.tree.map(np.asarray, params), tcfg)
    named = dict(tmodel.named_parameters())
    assert set(flat) == set(named)
    assert {"feature_proj.w", "feature_proj.b", "head.w", "ln_f.bias",
            "layers.1.ffn.up_b", "layers.0.ln2.scale"} <= set(named)
    for name, p in named.items():
        assert np.array_equal(p.detach().numpy(), flat[name]), name
    del params["head"]
    with pytest.raises(KeyError, match="missing"):
        interop.lm_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
