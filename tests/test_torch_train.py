"""The port's training against the JAX package on the CPU: every family's
loss and gradients, remat, the optimizers, the train step, the data
pipeline, checkpoints, the fault runner, compression, the launcher and the
examples.

Parameters come from the JAX model's init (f32 storage in both), inputs
from numpy. Tolerances: f32 losses ``rtol=1e-5``; each gradient tensor
within ``2e-4`` of its largest element (the frameworks sum matmul
products in different orders; the worst read 5.7e-5, zamba2's embedding
through its nine stages, the rest under 5e-6); optimizer states after a
few steps ``rtol=atol=1e-6`` (f32 elementwise maths; ``pow`` and ``cos``
may differ by an ulp between the two libraries); a train step's
parameters ``rtol=atol=2e-5`` under SGD (its gradients' error, times the
learning rate), and under AdamW ``atol`` 1e-2 of the learning rate:
Adam divides each gradient element by its own running scale, so an
element whose gradient is near zero turns the frameworks' rounding into
an update of up to O(lr) (one element of 32768 read 0.5% of lr). The
data pipeline and the compression are bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models.registry import build_model as jax_build
from repro.train import checkpoint as JK
from repro.train import compression as JZ
from repro.train import data as JD
from repro.train import fault as JF
from repro.train import optimizer as JO
from repro.train import trainstep as JT
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.kernels import conv1d as TK
from repro_torch.kernels import flash_attention as TF
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as TKP
from repro_torch.train import compression as TZ
from repro_torch.train import data as TD
from repro_torch.train import fault as TFT
from repro_torch.train import optimizer as TO
from repro_torch.train import trainstep as TT

ARCHS = sorted(JC.ARCHS)
GRAD_SHARE = 2e-4
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=2e-5, atol=2e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(arch, **kw):
    return (dataclasses.replace(JC.get_smoke_config(arch), dtype=jnp.float32,
                                **kw),
            dataclasses.replace(TC.get_smoke_config(arch),
                                dtype=torch.float32, **kw))


def _batch(tcfg, seed=0, b=2, s=32):
    """The reference smoke batch's shapes (``tests/test_archs_smoke.py``),
    drawn with numpy: (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, tcfg.vocab_size, (b, s))}
    if tcfg.family == "encoder":
        out["features"] = rng.standard_normal(
            (b, s, tcfg.audio_feat_dim)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, tcfg.vocab_size, (b, s))
    if tcfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (b, tcfg.vlm_image_tokens, tcfg.vlm_vision_dim)
        ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _models(arch, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jmodel = jax_build(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    return tcfg, jmodel, params, tmodel


def _port_grads(tmodel, batch):
    loss, metrics = tmodel.loss(batch)
    named = dict(tmodel.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), metrics, dict(zip(named, grads))


def _close_grads(got: dict, want_flat: dict, what=""):
    """Each tensor within GRAD_SHARE of its largest JAX element."""
    assert set(got) == set(want_flat), what
    for name, g in got.items():
        want = np.asarray(want_flat[name], np.float32)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_SHARE * float(np.abs(want).max()) + 1e-12, (
            f"{what}{name}: max |diff| {err}, max |g| "
            f"{float(np.abs(want).max())}")


def _close_tree(got: dict, want_flat: dict, tol, what=""):
    assert set(got) == set(want_flat), what
    for name, g in got.items():
        np.testing.assert_allclose(
            g.detach().float().numpy(),
            np.asarray(want_flat[name], np.float32), err_msg=f"{what}{name}",
            **tol)


# ----------------------- every family's loss and grads -----------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    tcfg, jmodel, params, tmodel = _models(arch, seed=1)
    jb, tb = _batch(tcfg)
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, jb)
    loss, metrics, grads = _port_grads(tmodel, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jm)
    for key in metrics:
        assert not metrics[key].requires_grad
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-6)
    _close_grads(grads, interop.port_names(
        jax.tree.map(np.asarray, jgrads), tcfg), f"{arch}: ")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b",
                                  "mamba2-2.7b", "zamba2-7b", "hubert-xlarge"])
def test_remat_modes_give_equal_grads(arch):
    """none, full and dots recompute the same f32 operations: equal
    gradients, bit for bit."""
    tcfg, _, params, _ = _models(arch)
    _, tb = _batch(tcfg)
    got = {}
    for mode in ("none", "full", "dots"):
        model = interop.lm_params_from_jax(
            jax.tree.map(np.asarray, params),
            dataclasses.replace(tcfg, remat=mode), device="cpu")
        got[mode] = _port_grads(model, tb)[2]
    for mode in ("full", "dots"):
        for name, g in got["none"].items():
            assert torch.equal(g, got[mode][name]), (mode, name)


def test_unknown_remat_mode_raises():
    from repro_torch.models.lm import remat
    with pytest.raises(ValueError, match="remat"):
        remat(lambda x: x, "everything")


def test_ce_from_hidden_matches_jax():
    from repro.models.lm import ce_from_hidden as jce
    from repro_torch.models.lm import ce_from_hidden as tce
    rng = np.random.default_rng(2)
    for s in (1024, 96):  # two chunks of 512; one odd-length chunk
        x = rng.standard_normal((2, s, 16)).astype(np.float32)
        w = rng.standard_normal((16, 256)).astype(np.float32)
        labels = rng.integers(0, 250, (2, s))
        want = jce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), 256,
                   250)
        got = tce(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(labels), 256, 250)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_cast_in_the_graph_under_grad_and_cached_without():
    """bf16 compute over f32 storage: with grad the cast is in the autograd
    graph (the gradient reaches the f32 parameter), without grad it is the
    cached copy."""
    _, tcfg = _cfgs("qwen2.5-3b")
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ffn = model.layers[0].ffn
    w = ffn.w("gate", torch.bfloat16)
    assert w.requires_grad and w.grad_fn is not None
    with torch.no_grad():
        cached = ffn.w("gate", torch.bfloat16)
        assert not cached.requires_grad
        assert ffn.w("gate", torch.bfloat16) is cached
    _, tb = _batch(tcfg)
    loss, _ = model.loss(tb)
    loss.backward()
    assert ffn.gate.grad is not None and float(ffn.gate.grad.abs().sum()) > 0


# ------------------------------ K8 and K7 ------------------------------

def test_flash_and_conv_kernels_refuse_a_gradient():
    """Forward-only, as the reference's Pallas kernels: with grad enabled
    and an input that requires grad they raise before any dispatch; under
    no_grad, or with inputs that need no grad, they run."""
    q = torch.randn(1, 64, 2, 16, requires_grad=True)
    k = torch.randn(1, 64, 2, 16)
    with pytest.raises(TF.GradientError, match="forward-only"):
        TF.flash_attention_local(q, k, k, bq=32, bk=32)
    with torch.no_grad():
        TF.flash_attention_local(q, k, k, bq=32, bk=32)
    TF.flash_attention_local(q.detach(), k, k, bq=32, bk=32)
    x = torch.randn(2, 16, 8)
    w = torch.randn(4, 8, requires_grad=True)
    with pytest.raises(TF.GradientError, match="forward-only"):
        TK.conv1d_depthwise_causal(x, w)
    with torch.no_grad():
        TK.conv1d_depthwise_causal(x, w)
    for arch, route in (("qwen2.5-3b", {"attn_impl": "flash",
                                        "attn_chunk": 16}),
                        ("mamba2-2.7b", {"ssm_conv_impl": "pallas"})):
        tcfg = dataclasses.replace(TC.get_smoke_config(arch), **route)
        with pytest.raises(TF.GradientError):
            build_model(tcfg, device="cpu").loss(_batch(tcfg)[1])


# ------------------------------ optimizers ------------------------------

def _tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (4, 8), "b.c": (16,), "b.d": (3, 5, 2)}


def _jopt(name, lr):
    return {"adamw": lambda: JO.adamw(lr, weight_decay=0.1),
            "adamw_bf16": lambda: JO.adamw(lr, moments_dtype=jnp.bfloat16),
            "lion": lambda: JO.lion(lr),
            "sgd": lambda: JO.sgd(lr, max_grad_norm=0.5)}[name]()


def _topt(name, lr):
    return {"adamw": lambda: TO.adamw(lr, weight_decay=0.1),
            "adamw_bf16": lambda: TO.adamw(lr, moments_dtype=torch.bfloat16),
            "lion": lambda: TO.lion(lr),
            "sgd": lambda: TO.sgd(lr, max_grad_norm=0.5)}[name]()


def _jflat(tree):
    return None if tree is None else {k: np.asarray(v, np.float32)
                                      for k, v in tree.items()}


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16", "lion", "sgd"])
def test_optimizer_continues_a_jax_run(name):
    """Two JAX steps, then the state crosses to the port and both run
    three more: the port's in-place ``update_`` leaves the parameters
    and moments of JAX's ``update`` + ``apply_updates`` after each."""
    rng = np.random.default_rng(3)
    lr = JO.warmup_cosine(1e-2, 2, 6)
    jopt, topt = _jopt(name, lr), _topt(name, TO.warmup_cosine(1e-2, 2, 6))
    params = {k: jnp.asarray(v) for k, v in _tree(rng, SHAPES).items()}
    state = jopt.init(params)
    grads = [_tree(rng, SHAPES, 2.0) for _ in range(5)]
    for g in grads[:2]:
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 state, params)
        params = JO.apply_updates(params, upd)
    mdt = torch.bfloat16 if name == "adamw_bf16" else torch.float32
    tp = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}

    def moments(tree):
        return None if tree is None else {
            k: torch.tensor(np.asarray(v, np.float32)).to(mdt)
            for k, v in tree.items()}

    ts = TO.OptState(torch.tensor(int(state.step), dtype=torch.int32),
                     moments(state.mu), moments(state.nu))
    for g in grads[2:]:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, state = jopt.update(jg, state, params)
        params = JO.apply_updates(params, upd)
        before = {k: v.clone() for k, v in tp.items()}
        ts = topt.update_({k: torch.from_numpy(v.copy())
                           for k, v in g.items()}, ts, tp)
        _close_tree({k: tp[k] - before[k] for k in tp}, _jflat(upd),
                    OPT_TOL, "update ")
        _close_tree(tp, _jflat(params), OPT_TOL, "params ")
        _close_tree(ts.mu, _jflat(state.mu), OPT_TOL, "mu ")
        if state.nu is not None:
            _close_tree(ts.nu, _jflat(state.nu), OPT_TOL, "nu ")
    assert int(ts.step) == int(state.step) == 5
    for k in tp:
        assert ts.mu[k].dtype == (mdt if name.startswith("adamw")
                                  else torch.float32)


def test_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(4)
    g = _tree(rng, SHAPES, 3.0)
    for max_norm in (0.5, 1e3):
        want, wnorm = JO.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        got, norm = TO.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
        _close_tree(got, _jflat(want), OPT_TOL)


def test_warmup_cosine_values_match_jax():
    j = JO.warmup_cosine(3e-3, 6, 50)
    t = TO.warmup_cosine(3e-3, 6, 50)
    for step in range(0, 55):
        np.testing.assert_allclose(float(t(step)), float(j(step)),
                                   rtol=1e-6, atol=1e-12)
    assert float(t(torch.tensor(7, dtype=torch.int32))) == float(t(7))


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_jax(accum):
    """Two steps of qwen2.5's smoke model under SGD with momentum and a
    clip at accumulation 1 and 2 against the JAX package's train step."""
    tcfg, jmodel, params, tmodel = _models("qwen2.5-3b", seed=2)
    jopt = JO.sgd(JO.warmup_cosine(1e-1, 1, 4), max_grad_norm=1.0)
    topt = TO.sgd(TO.warmup_cosine(1e-1, 1, 4), max_grad_norm=1.0)
    jstep = jax.jit(JT.make_train_step(jmodel, jopt, accum))
    tstep = TT.make_train_step(tmodel, topt, accum)
    jstate = JT.TrainState(params, jopt.init(params))
    tstate = TT.init_state(tmodel, topt)
    for seed in (5, 6):
        jb, tb = _batch(tcfg, seed=seed, b=4)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]),
                                   rtol=1e-5)
    flat = interop.port_names(jax.tree.map(np.asarray, jstate.params), tcfg)
    _close_tree(tstate.params, flat, STEP_TOL)
    _close_tree(tstate.opt_state.mu, interop.port_names(
        jax.tree.map(np.asarray, jstate.opt_state.mu), tcfg), STEP_TOL)
    assert int(tstate.opt_state.step) == 2


def test_train_state_from_jax_continues_the_run():
    """A JAX run of two steps crosses to the port, which takes the third;
    so does the JAX run: the states agree."""
    tcfg, jmodel, params, _ = _models("qwen3-moe-30b-a3b", seed=3)
    jopt = JO.adamw(1e-2)
    jstep = jax.jit(JT.make_train_step(jmodel, jopt))
    jstate = JT.TrainState(params, jopt.init(params))
    for seed in (7, 8):
        jstate, _ = jstep(jstate, _batch(tcfg, seed=seed)[0])
    model, tstate = interop.train_state_from_jax(
        jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    assert int(tstate.opt_state.step) == 2
    jb, tb = _batch(tcfg, seed=9)
    jstate, jm = jstep(jstate, jb)
    tstate, tm = TT.make_train_step(model, TO.adamw(1e-2))(tstate, tb)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    adam_tol = dict(rtol=2e-5, atol=1e-2 * 1e-2)  # 1e-2 of lr (module note)
    _close_tree(tstate.params, interop.port_names(
        jax.tree.map(np.asarray, jstate.params), tcfg), adam_tol)
    _close_tree(tstate.opt_state.nu, interop.port_names(
        jax.tree.map(np.asarray, jstate.opt_state.nu), tcfg), STEP_TOL)


def test_a_failing_step_leaves_the_state_untouched():
    tcfg, _, _, tmodel = _models("qwen2.5-3b")
    opt = TO.adamw(1e-2)
    step = TT.make_train_step(tmodel, opt)
    state = TT.init_state(tmodel, opt)
    state, _ = step(state, _batch(tcfg, seed=1)[1])
    before = {k: v.clone() for k, v in state.params.items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    _, tb = _batch(tcfg, seed=2)
    tb["labels"] = tb["labels"] + tcfg.padded_vocab  # out of range: raises
    with pytest.raises((IndexError, RuntimeError)):
        step(state, tb)
    assert int(state.opt_state.step) == 1
    for k in before:
        assert torch.equal(before[k], state.params[k])
        assert torch.equal(mu[k], state.opt_state.mu[k])
    with pytest.raises(ValueError, match="model's own parameters"):
        step(TT.TrainState({k: v.clone() for k, v in state.params.items()},
                           state.opt_state), _batch(tcfg)[1])


# --------------------------------- data ---------------------------------

@pytest.mark.parametrize("hosts", [(1, 0), (2, 1)])
def test_synthetic_batches_equal_jax_bit_for_bit(hosts):
    n, host = hosts
    kw = dict(vocab_size=97, seq_len=24, global_batch=6, seed=3,
              num_hosts=n, host_id=host)
    want = JD.make_pipeline(JD.DataConfig(**kw))
    got = TD.make_pipeline(TD.DataConfig(**kw))
    for start in (0, 7):  # a restart at step 7 reads what step 7 read
        for jb, tb in zip(want.batches(start), got.batches(start)):
            assert jb["step"] == tb["step"]
            assert np.array_equal(jb["tokens"], tb["tokens"])
            assert np.array_equal(jb["labels"], tb["labels"])
            assert tb["tokens"].shape == (6 // n, 24)
            if tb["step"] >= start + 3:
                break


def test_binary_token_batches_equal_jax_bit_for_bit(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(4).integers(0, 60000, 5000, dtype=np.uint16
                                      ).tofile(path)
    for n, host in ((1, 0), (2, 0), (2, 1)):
        kw = dict(vocab_size=60000, seq_len=32, global_batch=4, seed=1,
                  path=str(path), num_hosts=n, host_id=host)
        want = JD.make_pipeline(JD.DataConfig(**kw)).batches(5)
        got = TD.make_pipeline(TD.DataConfig(**kw)).batches(5)
        for _ in range(3):
            jb, tb = next(want), next(got)
            assert np.array_equal(jb["tokens"], tb["tokens"])
            assert np.array_equal(jb["labels"], tb["labels"])


# ------------------------------ checkpoints ------------------------------

def _ckpt_tree():
    g = torch.Generator().manual_seed(0)
    return TT.TrainState(
        {"w": torch.randn(4, 3, generator=g),
         "b16": torch.randn(5, generator=g).to(torch.bfloat16)},
        TO.OptState(torch.tensor(7, dtype=torch.int32),
                    {"w": torch.randn(4, 3, generator=g),
                     "b16": torch.randn(5, generator=g)}, None))


def test_checkpoint_round_trip_layout_and_gc(tmp_path):
    tree = _ckpt_tree()
    d = str(tmp_path / "ck")
    for step in (1, 2, 3, 4):
        TKP.save(d, step, tree, meta={"arch": "x"}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert TKP.latest_step(d) == 4 and TKP.read_meta(d, 4) == {
        "step": 4, "n_leaves": 5, "arch": "x"}
    with np.load(os.path.join(d, "step_00000004", "arrays.npz")) as z:
        assert sorted(z.files) == [f"leaf_{i}" for i in range(5)]
        # sorted keys: params.b16 is leaf 0; bf16 as raw 2-byte records
        assert z["leaf_0"].dtype == np.dtype("V2")
    like = _ckpt_tree()._replace(params={
        k: torch.zeros_like(v) for k, v in tree.params.items()})
    keep = like.params["w"]
    got = TKP.restore(d, 4, like)
    assert got.params["w"] is keep  # written in place
    for a, b in zip(TKP._flatten(got)[0], TKP._flatten(tree)[0]):
        assert torch.equal(torch.as_tensor(a), b)
    assert got.params["b16"].dtype == torch.bfloat16
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert TKP.latest_step(d) == 4
    assert TKP.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_leaf_order_is_the_references(tmp_path):
    """A tree of numpy leaves saved by both packages gives the same npz."""
    rng = np.random.default_rng(5)
    tree = {"z": rng.standard_normal(3).astype(np.float32),
            "a": {"y": rng.standard_normal((2, 2)).astype(np.float32),
                  "b": np.arange(4, dtype=np.int32)}}
    JK.save(str(tmp_path / "j"), 1, tree)
    TKP.save(str(tmp_path / "t"), 1, tree)
    with np.load(tmp_path / "j" / "step_00000001" / "arrays.npz") as zj, \
            np.load(tmp_path / "t" / "step_00000001" / "arrays.npz") as zt:
        assert zj.files == zt.files
        for f in zj.files:
            assert np.array_equal(zj[f], zt[f])


def test_checkpoint_mismatch_raises_before_writing(tmp_path):
    tree = _ckpt_tree()
    d = str(tmp_path / "ck")
    TKP.save(d, 1, tree)
    more = tree._replace(params={**tree.params, "extra": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        TKP.restore(d, 1, more)
    like = _ckpt_tree()
    like.params["w"].zero_()
    bad = like._replace(opt_state=like.opt_state._replace(
        mu={**like.opt_state.mu, "w": torch.zeros(3, 4)}))
    with pytest.raises(ValueError, match="shape"):
        TKP.restore(d, 1, bad)
    assert float(like.params["w"].abs().sum()) == 0.0  # nothing written


def test_async_checkpointer_snapshots_at_call(tmp_path):
    tree = _ckpt_tree()
    ck = TKP.AsyncCheckpointer(str(tmp_path / "ck"), keep=3)
    ck.save_async(1, tree)
    with torch.no_grad():
        tree.params["w"].add_(1.0)  # after the call: not in the snapshot
    ck.save_async(2, tree)
    ck.wait()
    assert TKP.latest_step(str(tmp_path / "ck")) == 2
    first = TKP.restore(str(tmp_path / "ck"), 1, _ckpt_tree())
    assert torch.equal(first.params["w"], _ckpt_tree().params["w"])
    assert threading.active_count() >= 1
    bad = TKP.AsyncCheckpointer(str(tmp_path / "file"))
    (tmp_path / "file").write_text("not a directory")
    bad.save_async(1, tree)
    with pytest.raises(OSError):
        bad.wait()


# ------------------------------ fault runner ------------------------------

def test_straggler_detector_flags_the_references_steps():
    """A fixed list of step times (no sleeps): both detectors flag the
    same steps with the same baselines."""
    rng = np.random.default_rng(6)
    times = list(0.1 + 0.002 * rng.standard_normal(40))
    times[0] = 5.0           # the first step's one-time costs
    for s in (14, 15, 27, 33):
        times[s] = 0.5
    kw = dict(min_steps_before_flag=5, straggler_zscore=3.0)
    jd = JF.StragglerDetector(JF.FaultConfig(**kw))
    td = TFT.StragglerDetector(TFT.FaultConfig(**kw))
    flags = [(jd.observe(i, t), td.observe(i, t)) for i, t in
             enumerate(times)]
    assert all(a == b for a, b in flags)
    assert [s for s, _, _ in td.events] == [14, 15, 27, 33]
    np.testing.assert_allclose(np.array(td.events), np.array(jd.events),
                               rtol=1e-12)


def _runner_state(seed=0):
    tcfg, _, _, tmodel = _models("qwen2.5-3b", seed=seed)
    opt = TO.adamw(1e-2)
    return tcfg, tmodel, TT.make_train_step(tmodel, opt), \
        TT.init_state(tmodel, opt)


def _batches(tcfg, n):
    data = TD.make_pipeline(TD.DataConfig(vocab_size=tcfg.vocab_size,
                                          seq_len=16, global_batch=2))
    out = []
    for b in data.batches():
        if b["step"] >= n:
            break
        out.append({"tokens": torch.from_numpy(b["tokens"]).long(),
                    "labels": torch.from_numpy(b["labels"]).long()})
    return out


@pytest.mark.parametrize("fail_at", [4, 2])
def test_failure_injection_gives_the_clean_runs_state(tmp_path, fail_at):
    """A step that raises is retried: after the checkpoint of step 3 (a
    restore, then the retry), or before any checkpoint (on the untouched
    state). Either way the run ends in the clean run's state, bit for
    bit."""
    tcfg, _, step, state = _runner_state()
    clean = TFT.FaultTolerantRunner(step, state, TFT.FaultConfig(
        ckpt_dir=str(tmp_path / "clean"), ckpt_every=3)).run(
            _batches(tcfg, 6), 6)
    want = {k: v.clone() for k, v in clean.params.items()}

    tcfg, _, inner, state = _runner_state()
    left = {"n": 1}

    def flaky(state, batch):
        if batch.get("_step") == fail_at and left["n"]:
            left["n"] -= 1
            raise RuntimeError("injected device failure")
        return inner(state, batch)

    batches = [dict(b, _step=i) for i, b in enumerate(_batches(tcfg, 6))]
    runner = TFT.FaultTolerantRunner(flaky, state, TFT.FaultConfig(
        ckpt_dir=str(tmp_path / "flaky"), ckpt_every=3))
    got = runner.run(batches, 6)
    assert runner.restores == 1
    for k in want:
        assert torch.equal(want[k], got.params[k]), k
    assert int(got.opt_state.step) == 6


def test_runner_gives_up_after_max_retries(tmp_path):
    tcfg, _, _, state = _runner_state()

    def broken(state, batch):
        raise RuntimeError("always")

    runner = TFT.FaultTolerantRunner(broken, state, TFT.FaultConfig(
        ckpt_dir=str(tmp_path / "ck"), max_retries=2))
    with pytest.raises(RuntimeError, match="always"):
        runner.run(_batches(tcfg, 2), 2)
    assert runner.restores == 3


def test_resume_or_init_restores_the_latest(tmp_path):
    tcfg, _, step, state = _runner_state()
    cfg = TFT.FaultConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    runner = TFT.FaultTolerantRunner(step, state, cfg)
    assert runner.resume_or_init() == 0
    runner.run(_batches(tcfg, 5), 5)
    saved = TKP.restore(cfg.ckpt_dir, 4, TT.init_state(
        _runner_state()[1], TO.adamw(1e-2)))
    tcfg, _, step, state = _runner_state(seed=9)
    again = TFT.FaultTolerantRunner(step, state, cfg)
    assert again.resume_or_init() == 5 and again.last_good_step == 4
    for k in saved.params:
        assert torch.equal(saved.params[k], again.state.params[k])


# ------------------------------ compression ------------------------------

def test_int8_quantization_and_error_feedback_match_jax():
    rng = np.random.default_rng(7)
    g = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves: round to even
    q, s = TZ.quantize_int8(torch.from_numpy(g))
    jq, js = JZ.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    assert np.array_equal(TZ.dequantize_int8(q, s).numpy(),
                          np.asarray(JZ.dequantize_int8(jq, js)))
    tef = TZ.init_ef({"g": torch.from_numpy(g)})
    jef = JZ.init_ef({"g": jnp.asarray(g)})
    for _ in range(3):  # error feedback: residual = (g + r) - dq(q(g + r))
        tg = torch.from_numpy(g) + tef.residual["g"]
        jg = jnp.asarray(g) + jef.residual["g"]
        tef = TZ.EFState({"g": tg - TZ.dequantize_int8(*TZ.quantize_int8(
            tg))})
        jef = JZ.EFState({"g": jg - JZ.dequantize_int8(*JZ.quantize_int8(
            jg))})
        assert np.array_equal(tef.residual["g"].numpy(),
                              np.asarray(jef.residual["g"]))


# -------------------------- the launcher, examples --------------------------

def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _digest(out):
    return [l for l in out.splitlines() if l.startswith("state digest=")][0]


def test_cli_trains_checkpoints_and_resumes_exactly(tmp_path):
    """A run killed once its first checkpoint is on disk and resumed with
    ``--resume auto`` ends in the uninterrupted run's state, bit for bit
    (the digest of every parameter and moment)."""
    base = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--batch",
            "8", "--seq", "64", "--steps", "12", "--ckpt-every", "3",
            "--deterministic"]
    full = _cli(*base, "--ckpt-dir", str(tmp_path / "a"))
    assert full.returncode == 0, full.stderr
    assert sum(line.startswith("step ") for line in
               full.stdout.splitlines()) == 12
    assert "done: 12 steps" in full.stdout
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *base,
         "--ckpt-dir", str(tmp_path / "b")], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    first = tmp_path / "b" / "step_00000003"
    deadline = time.monotonic() + 240
    while not first.exists() and child.poll() is None \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    child.kill()
    child.wait()
    assert first.exists()
    again = _cli(*base, "--ckpt-dir", str(tmp_path / "b"), "--resume", "auto")
    assert again.returncode == 0, again.stderr
    assert "resumed from step " in again.stdout
    assert _digest(again.stdout) == _digest(full.stdout)
    moe = _cli("--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
               "--steps", "2", "--batch", "2", "--seq", "64", "--accum", "2",
               "--optimizer", "lion", "--ckpt-dir", str(tmp_path / "c"))
    assert moe.returncode == 0, moe.stderr
    enc = _cli("--arch", "hubert-xlarge", "--smoke", "--device", "cpu")
    assert enc.returncode != 0 and "encoder-only" in enc.stderr


def test_example_twins_run_on_the_cpu(tmp_path):
    from repro_torch.examples import fault_tolerant_training, train_lm
    losses = train_lm.main(["--device", "cpu", "--steps", "12"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    runner = fault_tolerant_training.main(
        ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ft")])
    assert runner.restores >= 1
