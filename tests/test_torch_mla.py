"""The port's MLA (multi-head latent attention, minicpm3) against the JAX
package's ``repro.layers.mla`` on the CPU.

Parameters are layer 0's of a JAX smoke ``DecoderLM`` (random init from a
seed), carried across with ``interop.load_params``; inputs are seeded
numpy arrays. Tolerances are ``tests/test_torch_lm.py``'s: f32
``rtol=atol=1e-5``, bf16 ``rtol=5e-2, atol=8e-2``. ``attn_chunk=16``, so
a 32-token prompt takes the long paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.layers import mla as JM
from repro.models.registry import build_model as jax_build
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.kernels import flash_attention as TF
from repro_torch.layers import mla as TM
from repro_torch.models.base import ParamInit

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=8e-2)}
B, SMAX = 2, 48

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
    kw = dict(attn_chunk=16, **kw)
    return (dataclasses.replace(JC.get_smoke_config("minicpm3-4b"),
                                dtype=jdt, **kw),
            dataclasses.replace(TC.get_smoke_config("minicpm3-4b"),
                                dtype=tdt, **kw))


def _layer(dname="float32", **kw):
    """(jcfg, tcfg, JAX params of layer 0's MLA, the port's MLA)."""
    jcfg, tcfg = _cfgs(dname, **kw)
    params, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    init = ParamInit(tcfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    tp = interop.load_params(TM.MLA(init, tcfg),
                             jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _x(dname, s, seed, d=64):
    a = np.random.default_rng(seed).standard_normal((B, s, d)).astype(
        np.float32)
    jdt, tdt = DT[dname]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _pos(start, s):
    p = np.broadcast_to(np.arange(start, start + s), (B, s)).astype(np.int32)
    return jnp.asarray(p), torch.from_numpy(p).long()


def _close(got, want, dname):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL[dname])


@pytest.mark.parametrize("q_lora", [True, False])
@pytest.mark.parametrize("dname", list(DT))
@pytest.mark.parametrize("s", [12, 32])
def test_expanded_path_without_a_cache(s, dname, q_lora):
    """Full attention (12 <= attn_chunk) and chunked (32 > attn_chunk);
    with ``q_lora_rank`` 0 the query is one projection (``q_proj``)."""
    kw = {} if q_lora else dict(q_lora_rank=0)
    jcfg, tcfg, jp, tp = _layer(dname, **kw)
    assert hasattr(tp, "q_up") == q_lora and hasattr(tp, "q_proj") != q_lora
    jx, tx = _x(dname, s, seed=s)
    jpos, tpos = _pos(0, s)
    want, jnone = JM.mla_attention(jp, jx, jpos, jcfg)
    got, tnone = TM.mla_attention(tp, tx, tpos, tcfg)
    assert jnone is None and tnone is None
    assert got.dtype == tx.dtype and got.shape == (B, s, tcfg.d_model)
    _close(got, want, dname)


@pytest.mark.parametrize("dname", list(DT))
def test_long_prefill_then_absorbed_decode(dname):
    """A 32-token prefill into an empty cache (the long path: latents
    written, context by the expanded path), then an 8-token chunk and a
    single token through the absorbed path over the latent cache."""
    jcfg, tcfg, jp, tp = _layer(dname)
    jcache = JM.init_mla_cache(jcfg, B, SMAX)
    tcache = TM.init_mla_cache(tcfg, B, SMAX, device="cpu")
    start = 0
    for s, seed in ((32, 1), (8, 2), (1, 3)):
        jx, tx = _x(dname, s, seed)
        jpos, tpos = _pos(start, s)
        want, jcache = JM.mla_attention(jp, jx, jpos, jcfg, jcache)
        got, tcache = TM.mla_attention(tp, tx, tpos, tcfg, tcache)
        start += s
        assert tcache.length == int(jcache.length) == start
        _close(got, want, dname)
        _close(tcache.c_kv, jcache.c_kv, dname)
        _close(tcache.k_rope, jcache.k_rope, dname)


def test_absorbed_decode_equals_the_expanded_path_in_f32():
    """The absorbed form is the expanded attention re-associated: token by
    token over the cache it gives the no-cache outputs at each position."""
    _, tcfg, _, tp = _layer("float32")
    _, tx = _x("float32", 32, seed=4)
    _, tpos = _pos(0, 32)
    full, _ = TM.mla_attention(tp, tx, tpos, tcfg)
    cache = TM.init_mla_cache(tcfg, B, SMAX, device="cpu")
    outs = []
    for i in range(32):
        out, cache = TM.mla_attention(tp, tx[:, i:i + 1], tpos[:, i:i + 1],
                                      tcfg, cache)
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_cache_overflow_raises():
    _, tcfg, _, tp = _layer("float32")
    cache = TM.init_mla_cache(tcfg, B, 8, device="cpu")
    _, tx = _x("float32", 9, seed=5)
    _, tpos = _pos(0, 9)
    with pytest.raises(ValueError, match="cannot append 9"):
        TM.mla_attention(tp, tx, tpos, tcfg, cache)


def test_mla_cache_shapes_match_the_reference():
    jcfg, tcfg = _cfgs()
    want = JM.init_mla_cache(jcfg, B, SMAX)
    got = TM.init_mla_cache(tcfg, B, SMAX, device="cpu")
    assert got.c_kv.shape == want.c_kv.shape == (B, SMAX, 16)
    assert got.k_rope.shape == want.k_rope.shape == (B, SMAX, 8)
    assert got.c_kv.dtype == tcfg.dtype and got.length == 0
    jstack = jax_build(jcfg).init_cache(B, SMAX)
    from repro_torch.models.lm import DecoderLM
    tstack = DecoderLM(tcfg, device="cpu").init_cache(B, SMAX)
    assert isinstance(tstack, TM.MLACache)
    assert tstack.c_kv.shape == jstack.c_kv.shape == (2, B, SMAX, 16)
    assert tstack.k_rope.shape == jstack.k_rope.shape == (2, B, SMAX, 8)
    full = TM.init_mla_cache(TC.get_config("minicpm3-4b"), 4, 2080,
                             layers=62, device="meta")
    assert full.c_kv.shape == (62, 4, 2080, 256)
    assert full.k_rope.shape == (62, 4, 2080, 32)


def test_mla_launches_no_flash_kernel(monkeypatch):
    """MLA's q/k head dim (nope + rope) differs from v's, so its long
    prefill runs the plain chunked attention with ``attn_impl="flash"``
    too, as the reference's; a dense model's long prefill does reach
    K8's wrapper."""
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    real = TF.flash_attention_local
    monkeypatch.setattr(TF, "flash_attention_local", spy)
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "flash_attention_local", spy)
    from repro_torch.models.lm import DecoderLM
    _, tcfg = _cfgs(attn_impl="flash")
    toks = torch.randint(0, 512, (B, 32),
                         generator=torch.Generator().manual_seed(0))
    model = DecoderLM(tcfg, device="cpu")
    model.forward({"tokens": toks})
    model.forward({"tokens": toks}, model.init_cache(B, SMAX))
    assert calls == []
    dense = dataclasses.replace(TC.get_smoke_config("chatglm3-6b"),
                                attn_chunk=16, attn_impl="flash")
    DecoderLM(dense, device="cpu").forward({"tokens": toks})
    assert len(calls) == dense.n_layers
