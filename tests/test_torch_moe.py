"""The port's MoE layer and qwen3-moe against the JAX package on the CPU.

Inputs and parameters are made with numpy and handed to both packages.
Tolerances: f32 compute ``rtol=atol=1e-5`` (gradients ``2e-4``: the two
frameworks sum the expert einsums' products in different orders); bf16
compute ``rtol=5e-2, atol=8e-2`` (the JAX package's flash-vs-jnp bound)
on the layer's output. The routing metrics (``moe_drop_frac`` and the
top-k ids) are exact: both packages route from the same f32 router
logits.

The whole bf16 model is held at a capacity factor of E/k (no token
drops) to half the JAX model's own bf16-vs-f32 gap, the hybrid's rule
(``tests/test_torch_hybrid.py``): the ratio read 0.024. At the default
factor a bf16 rounding that flips one token's top-k also moves the slots
of the later tokens of its group, and the two packages' bf16 logits
differ by about as much as bf16 differs from f32 (3.125 against the JAX
model's own 3.103 on the smoke model; ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.layers import moe as JM
from repro.models.registry import build_model as jax_build
from repro.models.registry import count_params as jax_count
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.layers import moe as TM
from repro_torch.models.base import ParamInit
from repro_torch.models.registry import count_params

ARCH = "qwen3-moe-30b-a3b"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=8e-2)}


def _cfgs(dname="float32", arch=ARCH, **kw):
    jdt, tdt = DT[dname]
    return (dataclasses.replace(JC.get_smoke_config(arch), dtype=jdt, **kw),
            dataclasses.replace(TC.get_smoke_config(arch), dtype=tdt, **kw))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _moe_tree(rng, tcfg, router_scale=0.3):
    d, f, e = tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    return {"router": (rng.standard_normal((d, e)) * router_scale
                       ).astype(np.float32),
            "gate": (rng.standard_normal((e, d, f)) * d ** -0.5
                     ).astype(np.float32),
            "up": (rng.standard_normal((e, d, f)) * d ** -0.5
                   ).astype(np.float32),
            "down": (rng.standard_normal((e, f, d)) * f ** -0.5
                     ).astype(np.float32)}


def _both_moe(tree, x, jcfg, tcfg, dname):
    jdt, tdt = DT[dname]
    p = interop.load_params(TM.MoE(ParamInit(tcfg, device="cpu"), tcfg),
                            tree)
    want = JM.moe_ffn(jax.tree.map(jnp.asarray, tree),
                      jnp.asarray(x, jdt), jcfg)
    with torch.no_grad():
        got = TM.moe_ffn(p, torch.from_numpy(x).to(tdt), tcfg)
    return got, want


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dname", list(DT))
def test_moe_ffn_matches_jax(dname, capacity_factor):
    """The smoke layer (8 experts, top 2, groups of 64) on 2 x 64 tokens:
    at the default capacity factor (cap 20 of a mean load of 16) and at
    0.5 (cap 8: most experts overflow)."""
    jcfg, tcfg = _cfgs(dname, moe_capacity_factor=capacity_factor)
    rng = np.random.default_rng(0)
    tree = _moe_tree(rng, tcfg)
    x = rng.standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    (got, aux), (want, jaux) = _both_moe(tree, x, jcfg, tcfg, dname)
    assert got.dtype == DT[dname][1] and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dname])
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    if capacity_factor < 1:
        assert float(aux["moe_drop_frac"]) > 0.2
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-5)


@pytest.mark.parametrize("dname", list(DT))
def test_zero_router_ties_route_as_lax_top_k(dname):
    """A zero router makes every probability 1/E: all ties. lax.top_k then
    picks experts 0..k-1 for every token, lower ids first, so those k
    experts overflow; the port must pick the same ids and slots."""
    jcfg, tcfg = _cfgs(dname)
    rng = np.random.default_rng(1)
    tree = _moe_tree(rng, tcfg)
    tree["router"][:] = 0.0
    x = rng.standard_normal((1, 64, tcfg.d_model)).astype(np.float32)
    probs = np.full((1, 64, tcfg.n_experts), 1 / tcfg.n_experts, np.float32)
    _, want_ids = jax.lax.top_k(jnp.asarray(probs), tcfg.experts_per_token)
    _, got_ids = TM.top_k(torch.from_numpy(probs), tcfg.experts_per_token)
    assert np.array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert got_ids[0, 0].tolist() == list(range(tcfg.experts_per_token))
    (got, aux), (want, jaux) = _both_moe(tree, x, jcfg, tcfg, dname)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dname])
    cap = TM.capacity(64, tcfg)
    assert cap == max(1, int(64 * 2 / 8 * 1.25)) == 20
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) \
        == pytest.approx(1 - cap / 64)


def test_top_k_breaks_partial_ties_by_lower_id():
    rng = np.random.default_rng(2)
    probs = rng.integers(0, 3, (4, 16, 8)).astype(np.float32)
    for k in (1, 2, 5):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = TM.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        assert np.array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("get", ["get_smoke_config", "get_config"])
def test_count_params_matches_jax(arch, get):
    """On the meta device: the 235b's ~235 B parameters allocate nothing."""
    cfg = getattr(TC, get)(arch)
    assert count_params(cfg) == jax_count(getattr(JC, get)(arch)) \
        == cfg.n_params()


def test_full_configs_equal_the_reference():
    for arch in ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
                 "hubert-xlarge"):
        for get in ("get_config", "get_smoke_config"):
            j, t = getattr(JC, get)(arch), getattr(TC, get)(arch)
            for field in dataclasses.fields(t):
                if field.name in ("dtype", "param_dtype", "ssm_conv_impl"):
                    continue
                assert getattr(t, field.name) == getattr(j, field.name), (
                    arch, field.name)
            assert str(t.param_dtype).split(".")[-1] == \
                jnp.dtype(j.param_dtype).name


def _model(dname="float32", **kw):
    jcfg, tcfg = _cfgs(dname, **kw)
    jmodel = jax_build(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    tmodel = interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    return jcfg, tcfg, jmodel, params, tmodel


@pytest.mark.parametrize("dname", list(DT))
def test_moe_model_forward_and_aux(dname):
    """f32 at the default capacity; bf16 without drops (module note)."""
    kw = {} if dname == "float32" else {"moe_capacity_factor": 4.0}
    jcfg, tcfg, jmodel, params, tmodel = _model(dname, **kw)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 64))
    want, _, jaux = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, cache, aux = tmodel.forward({"tokens": torch.from_numpy(toks)})
    assert cache is None and set(aux) == set(jaux)
    if dname == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL[dname])
    else:
        exact, _, _ = jax_build(dataclasses.replace(
            jcfg, dtype=jnp.float32)).forward(params,
                                              {"tokens": jnp.asarray(toks)})
        gap = float(np.abs(got.numpy() - _np(want)).max())
        noise = float(np.abs(_np(want) - _np(exact)).max())
        assert gap <= 0.5 * noise, (gap, noise)
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-4)


def test_moe_prefill_decode_matches_full_forward():
    """As the reference's ``test_prefill_decode_matches_full_forward``
    (rtol 0.1, atol 0.15 in bf16; 1e-5 in f32), at a capacity factor of
    E/k, where no token drops: at the default factor a group's capacity
    depends on its length (a decode step is a group of B tokens at
    capacity 1), so prefill + decode routes otherwise than the full
    forward, in the reference as in the port. At the default factor the
    port's decode step equals the JAX model's (its logits and
    ``moe_drop_frac``)."""
    for dname, tol in (("bfloat16", dict(rtol=0.1, atol=0.15)),
                       ("float32", TOL["float32"])):
        jcfg, tcfg, jmodel, params, tmodel = _model(
            dname, moe_capacity_factor=4.0)
        b, s = 2, 16
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, tcfg.vocab_size, (b, s)))
        with torch.no_grad():
            full, _, _ = tmodel.forward({"tokens": toks})
            cache = tmodel.init_cache(b, max_len=s + 8)
            pre, cache, _ = tmodel.forward({"tokens": toks[:, :-1]}, cache)
            step, cache, aux = tmodel.forward({"tokens": toks[:, -1:]}, cache)
        np.testing.assert_allclose(step[:, 0].float().numpy(),
                                   full[:, -1].float().numpy(), **tol)
        np.testing.assert_allclose(pre[:, 5].float().numpy(),
                                   full[:, 5].float().numpy(), **tol)
    jcfg, tcfg, jmodel, params, tmodel = _model("float32")
    b, s = 2, 16
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (b, s)))
    with torch.no_grad():
        cache = tmodel.init_cache(b, max_len=s + 8)
        _, cache, _ = tmodel.forward({"tokens": toks[:, :-1]}, cache)
        step, cache, aux = tmodel.forward({"tokens": toks[:, -1:]}, cache)
    jcache = jmodel.init_cache(b, s + 8)
    _, jcache, _ = jmodel.forward(
        params, {"tokens": jnp.asarray(toks[:, :-1].numpy())}, jcache)
    jstep, _, jaux = jmodel.forward(
        params, {"tokens": jnp.asarray(toks[:, -1:].numpy())}, jcache)
    np.testing.assert_allclose(step.numpy(), _np(jstep),
                               **TOL["float32"])
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    assert float(aux["moe_drop_frac"]) > 0


def _grads_close(tgrads, jgrads, tcfg, rtol, atol):
    flat = interop.port_names(jax.tree.map(np.asarray, jgrads), tcfg)
    assert set(flat) == set(tgrads)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(flat[name],
                                                         np.float32),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"])
def test_moe_loss_and_grads_match_jax_value_and_grad(arch):
    """f32 compute and f32 storage in both packages (bf16 storage would
    round the f32 router): the loss with its aux terms, the metrics and
    every gradient."""
    jcfg, tcfg, jmodel, params, tmodel = _model("float32", arch=arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (2, 64))
    labels = rng.integers(0, tcfg.vocab_size, (2, 64))
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, metrics = tmodel.loss({"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels)})
    named = dict(tmodel.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jm)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-6)
    _grads_close(grads, jgrads, tcfg, rtol=2e-4, atol=2e-5)
