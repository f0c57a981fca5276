"""The port's LM layers and DecoderLM against the JAX package on the CPU.

Inputs and parameters are made with numpy and handed to both packages;
the JAX flash path runs its Pallas kernel in interpret mode. Tolerances:
f32 compute ``rtol=atol=1e-5``; bf16 compute ``rtol=5e-2, atol=8e-2``
(the JAX package's flash-vs-jnp bound, ``tests/test_flash_integration.py``),
since the two frameworks round bf16 at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.layers import attention as JA
from repro.layers import basic as JB
from repro.layers import rope as JR
from repro.models.registry import build_model as jax_build
from repro.models.registry import count_params as jax_count
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.layers import attention as TA
from repro_torch.layers import basic as TB
from repro_torch.layers import rope as TR
from repro_torch.models.base import ParamInit
from repro_torch.models.lm import DecoderLM
from repro_torch.models.registry import build_model, count_params

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=8e-2)}

@pytest.fixture(autouse=True)
def _forward_without_grad():
    """These tests hold the forward (serving) path, which runs under
    ``torch.no_grad()`` as ``ServeEngine`` does: parameters require grad
    by default, and K8 and K7 refuse a gradient. Training is held in
    ``tests/test_torch_train.py``."""
    with torch.no_grad():
        yield


def _cfgs(arch, dname="float32", **kw):
    jdt, tdt = DT[dname]
    return (dataclasses.replace(JC.get_smoke_config(arch), dtype=jdt, **kw),
            dataclasses.replace(TC.get_smoke_config(arch), dtype=tdt, **kw))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dname):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dname])


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale)


def _both(a, dname):
    jdt, tdt = DT[dname]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _cpu_init(tcfg):
    return ParamInit(tcfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))


# ----------------------------- layers -----------------------------

@pytest.mark.parametrize("dname", list(DT))
def test_rms_norm(dname):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64)
    scale = 1.0 + 0.1 * _rand(rng, 64)
    jx, tx = _both(x, dname)
    p = interop.load_params(TB.RMSNorm(_cpu_init(_cfgs("qwen2.5-3b")[1]),
                                       64), {"scale": scale})
    got = TB.rms_norm(p, tx, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, JB.rms_norm({"scale": jnp.asarray(scale)}, jx, 1e-5), dname)


@pytest.mark.parametrize("frac", [1.0, 0.5])
@pytest.mark.parametrize("dname", list(DT))
def test_apply_rope(dname, frac):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = np.stack([np.arange(7), np.arange(5, 12)]).astype(np.int32)
    jx, tx = _both(x, dname)
    want = JR.apply_rope(jx, jnp.asarray(pos), frac=frac, theta=1e6)
    got = TR.apply_rope(tx, torch.from_numpy(pos), frac=frac, theta=1e6)
    assert got.dtype == tx.dtype
    _close(got, want, dname)


@pytest.mark.parametrize("dname", list(DT))
def test_swiglu(dname):
    jcfg, tcfg = _cfgs("qwen2.5-3b", dname)
    rng = np.random.default_rng(2)
    tree = {"gate": _rand(rng, 64, 160, scale=0.125),
            "up": _rand(rng, 64, 160, scale=0.125),
            "down": _rand(rng, 160, 64, scale=0.08)}
    x = _rand(rng, 2, 5, 64)
    jx, tx = _both(x, dname)
    p = interop.load_params(TB.SwiGLU(_cpu_init(tcfg), 64, 160), tree)
    want = JB.swiglu(jax.tree.map(jnp.asarray, tree), jx, jcfg)
    _close(TB.swiglu(p, tx, tcfg), want, dname)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-7b"])
@pytest.mark.parametrize("dname", list(DT))
def test_embed_unembed(arch, dname):
    """Tied head (qwen) is the table's transpose; untied (deepseek) has its
    own head. Logits are f32 over the padded vocab."""
    jcfg, tcfg = _cfgs(arch, dname)
    rng = np.random.default_rng(3)
    v, d = tcfg.padded_vocab, tcfg.d_model
    tree = {"table": _rand(rng, v, d, scale=0.02)}
    if not tcfg.tie_embeddings:
        tree["head"] = _rand(rng, d, v, scale=0.125)
    p = interop.load_params(TB.Embedding(_cpu_init(tcfg), tcfg), tree)
    jp = {"embedding": jax.tree.map(jnp.asarray, tree)}
    toks = rng.integers(0, tcfg.vocab_size, (2, 6))
    got = TB.embed(p, torch.from_numpy(toks), tcfg)
    _close(got, JB.embed(jp, jnp.asarray(toks), jcfg), dname)
    x = _rand(rng, 2, 6, d)
    jx, tx = _both(x, dname)
    logits = TB.unembed(p, tx, tcfg)
    assert logits.dtype == torch.float32 and logits.shape[-1] == v
    _close(logits, JB.unembed(jp, jx, jcfg), dname)


def _gqa_tree(rng, tcfg):
    d, h, k, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd
    tree = {"wq": _rand(rng, d, h * hd, scale=d ** -0.5),
            "wk": _rand(rng, d, k * hd, scale=d ** -0.5),
            "wv": _rand(rng, d, k * hd, scale=d ** -0.5),
            "wo": _rand(rng, h * hd, d, scale=(h * hd) ** -0.5)}
    if tcfg.qkv_bias:
        tree |= {"bq": _rand(rng, h * hd, scale=0.1),
                 "bk": _rand(rng, k * hd, scale=0.1),
                 "bv": _rand(rng, k * hd, scale=0.1)}
    return tree


@pytest.mark.parametrize("impl", ["jnp", "flash"])
@pytest.mark.parametrize("dname", list(DT))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-7b"])
def test_attention_no_cache_prefill_and_decode(arch, dname, impl):
    """attention() without a cache, with a cache at prefill (the long path,
    64 > attn_chunk), then one decode step over the cache."""
    jcfg, tcfg = _cfgs(arch, dname, attn_chunk=16, attn_impl=impl)
    rng = np.random.default_rng(4)
    tree = _gqa_tree(rng, tcfg)
    p = interop.load_params(TA.GQA(_cpu_init(tcfg), tcfg), tree)
    jp = jax.tree.map(jnp.asarray, tree)
    b, s, smax = 2, 64, 72
    x = _rand(rng, b, s, tcfg.d_model)
    jx, tx = _both(x, dname)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos).long()

    want, _ = JA.attention(jp, jx, jpos, jcfg)
    got, none = TA.attention(p, tx, tpos, tcfg)
    assert none is None
    _close(got, want, dname)

    jcache = JA.init_kv_cache(jcfg, b, smax)
    tcache = TA.init_kv_cache(tcfg, b, smax, device="cpu")
    want, jcache = JA.attention(jp, jx, jpos, jcfg, jcache)
    got, tcache = TA.attention(p, tx, tpos, tcfg, tcache)
    assert tcache.length == int(jcache.length) == s
    _close(got, want, dname)
    _close(tcache.k, jcache.k, dname)
    _close(tcache.v, jcache.v, dname)

    x1 = _rand(rng, b, 1, tcfg.d_model)
    jx1, tx1 = _both(x1, dname)
    pos1 = np.full((b, 1), s, np.int32)
    want, jcache = JA.attention(jp, jx1, jnp.asarray(pos1), jcfg, jcache)
    got, tcache = TA.attention(p, tx1, torch.from_numpy(pos1).long(), tcfg,
                               tcache)
    assert tcache.length == int(jcache.length) == s + 1
    _close(got, want, dname)


def test_kv_cache_k_and_v_are_separate_buffers():
    """The reference's init_kv_cache returns one array for K and V; the
    port writes in place, so it must allocate two."""
    _, tcfg = _cfgs("qwen2.5-3b")
    cache = TA.init_kv_cache(tcfg, 2, 8, device="cpu")
    assert cache.k.data_ptr() != cache.v.data_ptr()
    cache.k[:, :3] = 1.0
    assert float(cache.v.abs().max()) == 0.0
    model = DecoderLM(tcfg, device="cpu")
    stacked = model.init_cache(2, 8)
    stacked.k[0, :, :2] = 2.0
    assert float(stacked.v.abs().max()) == 0.0


# ----------------------------- model -----------------------------

def _jax_model(jcfg, seed=0):
    model = jax_build(jcfg)
    params, _ = model.init(jax.random.PRNGKey(seed))
    return model, params


def _port_model(tcfg, params):
    return interop.lm_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")


@pytest.mark.parametrize("impl", ["jnp", "flash"])
@pytest.mark.parametrize("dname", list(DT))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-7b"])
def test_decoder_forward_logits(arch, dname, impl):
    jcfg, tcfg = _cfgs(arch, dname, attn_chunk=16, attn_impl=impl)
    jmodel, params = _jax_model(jcfg)
    tmodel = _port_model(tcfg, params)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 64))
    want, _, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    got, cache, aux = tmodel.forward({"tokens": torch.from_numpy(toks)})
    assert cache is None and aux == {}
    assert got.shape == (2, 64, tcfg.padded_vocab)
    _close(got, want, dname)


NEW_ARCHS = ["chatglm3-6b", "minicpm3-4b", "internvl2-2b"]


def _batches(tcfg, seed, n_tok=64):
    """Tokens (and for the VLM, 8 image embeddings ahead of 56 tokens) as
    a JAX batch and a port batch."""
    rng = np.random.default_rng(seed)
    if tcfg.family == "vlm":
        n_img = tcfg.vlm_image_tokens
        img = _rand(rng, 2, n_img, tcfg.vlm_vision_dim)
        toks = rng.integers(0, tcfg.vocab_size, (2, n_tok - n_img))
        return ({"tokens": jnp.asarray(toks),
                 "image_embeds": jnp.asarray(img)},
                {"tokens": torch.from_numpy(toks),
                 "image_embeds": torch.from_numpy(img)})
    toks = rng.integers(0, tcfg.vocab_size, (2, n_tok))
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


@pytest.mark.parametrize("impl", ["jnp", "flash"])
@pytest.mark.parametrize("dname", list(DT))
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_families_forward_logits(arch, dname, impl):
    """chatglm3 (half-dim rotary, kv 2), minicpm3 (MLA) and internvl2
    (its text backbone, with image embeddings ahead of the text)."""
    jcfg, tcfg = _cfgs(arch, dname, attn_chunk=16, attn_impl=impl)
    jmodel, params = _jax_model(jcfg, seed=2)
    tmodel = _port_model(tcfg, params)
    jb, tb = _batches(tcfg, seed=7)
    want, _, _ = jmodel.forward(params, jb)
    got, cache, aux = tmodel.forward(tb)
    assert cache is None and aux == {}
    assert got.shape == (2, 64, tcfg.padded_vocab)
    _close(got, want, dname)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_families_prefill_and_decode_with_cache(arch):
    jcfg, tcfg = _cfgs(arch, attn_chunk=16, attn_impl="flash")
    jmodel, params = _jax_model(jcfg, seed=3)
    tmodel = _port_model(tcfg, params)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 32))
    jcache = jmodel.init_cache(2, 48)
    tcache = tmodel.init_cache(2, 48)
    want, jcache, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)},
                                     jcache, last_only=True)
    got, tcache, _ = tmodel.forward({"tokens": torch.from_numpy(toks)},
                                    tcache, last_only=True)
    assert type(tcache).__name__ == type(jcache).__name__
    assert tcache.length == int(jcache.length[0]) == 32
    _close(got, want, "float32")
    for nxt in ([[3], [7]], [[11], [5]]):
        want, jcache, _ = jmodel.forward(
            params, {"tokens": jnp.asarray(nxt)}, jcache)
        got, tcache, _ = tmodel.forward({"tokens": torch.tensor(nxt)},
                                        tcache)
        _close(got, want, "float32")
    assert tcache.length == 34


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_families_serve_the_jax_greedy_tokens(arch):
    """f32 greedy serving, two waves of two 64-token prompts (the second
    left-padded from 40), through the long prefill path; the VLM serves
    its text backbone (the JAX server passes tokens only)."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JEngine
    from repro_torch.serve.engine import Request, ServeEngine
    jcfg, tcfg = _cfgs(arch, attn_chunk=16, attn_impl="flash")
    jmodel, params = _jax_model(jcfg, seed=4)
    tmodel = _port_model(tcfg, params)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, tcfg.vocab_size, n, dtype=np.int32)
               for n in (64, 64, 64, 40)]
    new = [5, 3, 4, 6]
    want = JEngine(jmodel, params, batch_size=2, max_len=80).generate(
        [JRequest(prompt=p, max_new_tokens=m) for p, m in zip(prompts, new)])
    got = ServeEngine(tmodel, batch_size=2, max_len=80).generate(
        [Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, new)])
    assert [len(r.generated) for r in got] == new
    assert [r.generated for r in got] == [r.generated for r in want]


def test_vlm_without_images_is_its_text_backbone():
    _, tcfg = _cfgs("internvl2-2b")
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    assert model.vision_proj.w.shape == (tcfg.vlm_vision_dim, tcfg.d_model)
    assert float(model.vision_proj.b.abs().max()) == 0.0
    _, tb = _batches(tcfg, seed=10)
    with_img, _, _ = model.forward(tb)
    text, _, _ = model.forward({"tokens": tb["tokens"]})
    n_img = tcfg.vlm_image_tokens
    assert with_img.shape[1] == text.shape[1] + n_img
    # The image tokens come first: the text's logits see them.
    assert not torch.allclose(with_img[:, n_img:], text)
    first, _, _ = model.forward({"tokens": tb["tokens"][:, :1]})
    torch.testing.assert_close(first[:, 0], text[:, 0])


def test_decoder_prefill_and_decode_with_cache():
    jcfg, tcfg = _cfgs("qwen2.5-3b", attn_chunk=16, attn_impl="flash")
    jmodel, params = _jax_model(jcfg, seed=1)
    tmodel = _port_model(tcfg, params)
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 32))
    jcache = jmodel.init_cache(2, 40)
    tcache = tmodel.init_cache(2, 40)
    want, jcache, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)},
                                     jcache, last_only=True)
    got, tcache, _ = tmodel.forward({"tokens": torch.from_numpy(toks)},
                                    tcache, last_only=True)
    assert got.shape == (2, 1, tcfg.padded_vocab) and tcache.length == 32
    _close(got, want, "float32")
    nxt = np.array([[3], [7]])
    want, jcache, _ = jmodel.forward(params, {"tokens": jnp.asarray(nxt)},
                                     jcache)
    got, tcache, _ = tmodel.forward({"tokens": torch.from_numpy(nxt)},
                                    tcache)
    assert tcache.length == 33
    _close(got, want, "float32")


def test_with_config_shares_parameters():
    _, tcfg = _cfgs("deepseek-7b", attn_chunk=16)
    model = DecoderLM(tcfg, device="cpu")
    flash = model.with_config(dataclasses.replace(tcfg, attn_impl="flash"))
    assert flash.embedding is model.embedding and model.cfg.attn_impl == "jnp"
    toks = torch.arange(64)[None] % tcfg.vocab_size
    a, _, _ = model.forward({"tokens": toks})
    b, _, _ = flash.forward({"tokens": toks})
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="execution knobs"):
        model.with_config(dataclasses.replace(tcfg, d_model=32))


def test_cast_copy_follows_parameter_edits():
    _, tcfg = _cfgs("qwen2.5-3b", "bfloat16")
    p = TB.RMSNorm(_cpu_init(tcfg), 4)
    first = p.w("scale", torch.bfloat16)
    assert first.dtype == torch.bfloat16 and p.w("scale",
                                                 torch.bfloat16) is first
    with torch.no_grad():
        p.scale.mul_(3.0)
    assert float(p.w("scale", torch.bfloat16)[0]) == 3.0


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-7b", *NEW_ARCHS])
def test_count_params_matches_jax(arch):
    for get in ("get_smoke_config", "get_config"):
        want = jax_count(getattr(JC, get)(arch))
        assert count_params(getattr(TC, get)(arch)) == want
    assert getattr(TC, "get_config")(arch).n_params() == want


def test_init_rule_shapes_and_scales():
    _, tcfg = _cfgs("qwen2.5-3b")
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    assert all(p.requires_grad for p in model.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    table = model.embedding.table
    assert table.shape == (tcfg.padded_vocab, tcfg.d_model)
    assert abs(float(table.std()) - 0.02) < 0.002
    wq = model.layers[0].attn.wq
    assert abs(float(wq.std()) - tcfg.d_model ** -0.5) < 0.01
    assert float(model.layers[1].attn.bq.abs().max()) == 0.0
    assert float(model.ln_f.scale.min()) == 1.0
    again = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.layers[1].ffn.down, model.layers[1].ffn.down)


def test_unported_archs_and_families_raise():
    """Every arch of the reference is ported, MoE and the encoder
    included; an unknown arch, and a family the decoder does not run,
    still raise."""
    assert set(TC.ARCHS) == set(JC.ARCHS)
    for arch in ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
                 "hubert-xlarge"):
        assert TC.get_config(arch).family == JC.get_config(arch).family
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_smoke_config("gpt-5")
    _, tcfg = _cfgs("qwen2.5-3b")
    for family in ("encoder", "ssm", "hybrid"):
        with pytest.raises(ValueError, match="dense, moe and vlm"):
            DecoderLM(dataclasses.replace(tcfg, family=family), device="cpu")
    with pytest.raises(ValueError, match="non-causal"):
        build_model(dataclasses.replace(tcfg, family="encoder"),
                    device="cpu")


def test_lm_params_from_jax_rejects_a_wrong_tree():
    jcfg, tcfg = _cfgs("qwen2.5-3b")
    _, params = _jax_model(jcfg)
    tree = jax.tree.map(np.asarray, params)
    del tree["layers"]["attn"]["bq"]
    with pytest.raises(KeyError, match="missing"):
        interop.lm_params_from_jax(tree, tcfg, device="cpu")
    with pytest.raises(ValueError, match="n_layers"):
        interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                   dataclasses.replace(tcfg, n_layers=3),
                                   device="cpu")
