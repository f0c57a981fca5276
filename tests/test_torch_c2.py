"""The sharded LM pieces of the port on an in-process mesh, on CPU shards,
against the JAX package's and against the unsharded port.

The JAX side runs in one subprocess with 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), as
``tests/test_pipeline.py`` and ``tests/test_ssm_sp.py`` do, at their
shapes, on inputs drawn with numpy from a seed and written beside its
results; the port reads both. That subprocess (``tests/_torch_c2_jax.py``)
runs once a test run, shared with ``tests/test_torch_c2_process.py``.

* ``dist.pipeline``: the GPipe schedule of 4 stages over 6 microbatches
  of the reference test's tanh MLP (8 layers of 32): within the
  reference's 2e-5 of the JAX pipeline and of the sequential forward,
  and bit for bit the port's sequential forward at equal microbatch
  size; gradients by autograd within its 5e-4 / 5e-5.
* ``core.ssm_sp``: the sequence-parallel SSD over 4 shards within the
  reference's 2e-4 of the JAX one and of the single-device SSD;
  ``conv_halo_exchange`` + the causal conv (K7's plain version on the
  CPU) bit for bit the unsharded conv and within the reference's 1e-4 of
  the JAX halo conv.
* ``kernels.ops.flash_attention`` under a (2, 2) data x model mesh: bit
  for bit the unsharded call, within 2e-5 (the flash tests' f32 bound) of
  the JAX sharded call.
* ``train.compression.compressed_psum`` over 4 replicas, int8 and bf16:
  bit for bit the same arithmetic on one device, and the JAX
  ``compressed_psum`` under ``shard_map`` within one f32 ulp of the
  largest gradient (int8: jitted XLA may divide by the scale as a
  multiply by its reciprocal, moving a dequantized value by an ulp; its
  all-reduce may sum in another order), the bf16 means within one bf16
  ulp (summed in bf16).
* ``train.fault.remesh_state`` of a ``TrainState`` from a (2, 2) mesh to
  (4, 1) and (1, 1): every shard's block equals the JAX
  ``remesh_state``'s block on the same device (its index and data), the
  gathered state equals the original bit for bit.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import ssm_sp
from repro_torch.dist import sharding as shd
from repro_torch.dist.mesh import ShardMesh
from repro_torch.dist.pipeline import pipeline_forward, split_stages
from repro_torch.kernels import ops
from repro_torch.kernels.conv1d import conv1d_depthwise_causal
from repro_torch.kernels.flash_attention import flash_attention_local
from repro_torch.layers.ssm import ssd_scan
from repro_torch.train.compression import (EFState, compressed_psum,
                                           dequantize_int8, quantize_int8)
from repro_torch.train.fault import remesh_state
from repro_torch.train.trainstep import TrainState

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_c2_jax  # noqa: E402

CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _torch_c2_jax.reference(tmp_path_factory)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stage_fn(w_local, h):
    for i in range(w_local.shape[0]):
        h = torch.tanh(h @ w_local[i])
    return h


def test_pipeline_matches_jax_and_sequential(ref):
    w = _t(ref["pipe_w"]).requires_grad_(True)
    x = _t(ref["pipe_x"])
    mesh = ShardMesh((4,), ("stage",), CPU4)
    pipe = pipeline_forward(lambda p, h: _stage_fn(p["w"], h), mesh)
    got = pipe(split_stages({"w": w}, 4), x)
    np.testing.assert_allclose(got.detach().numpy(), ref["pipe_y"],
                               rtol=2e-5, atol=2e-5)
    # bit for bit the sequential forward, microbatch by microbatch
    with torch.no_grad():
        seq = torch.stack([_stage_fn(w, x[m]) for m in range(x.shape[0])])
        assert torch.equal(got.detach(), seq)
        whole = _stage_fn(w, x.reshape(-1, x.shape[-1])).reshape(x.shape)
    np.testing.assert_allclose(got.detach().numpy(), whole.numpy(),
                               rtol=2e-5, atol=2e-5)
    (g,) = torch.autograd.grad(torch.sum(got ** 2), [w])
    np.testing.assert_allclose(g.numpy(), ref["pipe_g"], rtol=5e-4,
                               atol=5e-5)
    w2 = w.detach().clone().requires_grad_(True)
    (gs,) = torch.autograd.grad(torch.sum(_stage_fn(
        w2, x.reshape(-1, x.shape[-1])) ** 2), [w2])
    np.testing.assert_allclose(g.numpy(), gs.numpy(), rtol=5e-4, atol=5e-5)
    # a list of per-stage modules works the same way
    layers = split_stages(list(w.detach()), 4)
    assert [len(s) for s in layers] == [2] * 4
    with pytest.raises(ValueError, match="divisible"):
        split_stages({"w": w}, 3)


def test_ssd_sequence_parallel_and_conv_halo(ref):
    mesh = ShardMesh((4,), ("sp",), CPU4)
    x, dt, a, b, c = (_t(ref[k]) for k in ("ssd_x", "ssd_dt", "ssd_a",
                                           "ssd_b", "ssd_c"))
    parts = [shd.lay_out(t, (None, "sp"), mesh).shards for t in (x, dt, b, c)]
    ys = ssm_sp.ssd_sequence_parallel(*parts[:2], a, *parts[2:], 32)
    got = torch.cat(ys, 1)
    want, _ = ssd_scan(x, dt, a, b, c, 32, torch.float32)
    assert float((got - want).abs().max()) < 2e-4
    assert float((got - _t(ref["ssd_y"])).abs().max()) < 2e-4
    assert torch.equal(ssm_sp.ssd_sequence_parallel(
        [x], [dt], a, [b], [c], 32)[0], want)
    xc, wc = _t(ref["conv_x"]), _t(ref["conv_w"])
    ext = ssm_sp.conv_halo_exchange(
        shd.lay_out(xc, (None, "sp"), mesh).shards, 4)
    outs = [conv1d_depthwise_causal(e, wc)[:, 3:] for e in ext]
    got_c = torch.cat(outs, 1)
    assert torch.equal(got_c, conv1d_depthwise_causal(xc, wc))
    assert float((got_c - _t(ref["conv_y"])).abs().max()) < 1e-4
    one = ssm_sp.conv_halo_exchange([xc], 4)[0]
    assert one.shape == (2, 259, 32) and not bool(one[:, :3].any())


def test_associative_scan_is_the_inclusive_scan():
    g = torch.Generator().manual_seed(1)
    for n in (1, 2, 3, 4, 5, 8):
        d = torch.rand((n, 3), generator=g)
        s = torch.randn((n, 3, 2, 2), generator=g)
        cd, cs = ssm_sp.associative_scan(ssm_sp._combine, (d, s))
        rd, rs = d[0], s[0]
        for i in range(n):
            if i:
                rd, rs = ssm_sp._combine((rd, rs), (d[i], s[i]))
            torch.testing.assert_close(cd[i], rd)
            torch.testing.assert_close(cs[i], rs)


def test_sharded_flash_attention(ref):
    q, k, v = (_t(ref[n]) for n in ("fa_q", "fa_k", "fa_v"))
    whole = flash_attention_local(q, k, v, causal=True, bq=64, bk=64)
    mesh = ShardMesh((2, 2), ("data", "model"), CPU4)
    with shd.use_mesh(mesh):
        got = ops.flash_attention(q, k, v, causal=True, bq=64, bk=64)
    assert torch.equal(got, whole)
    np.testing.assert_allclose(got.numpy(), ref["fa_y"], rtol=2e-5,
                               atol=2e-5)
    # a mesh whose model axis the KV heads cannot split: batch only
    with shd.use_mesh(ShardMesh((1, 4), ("data", "model"), CPU4)):
        assert torch.equal(ops.flash_attention(q, k, v, bq=64, bk=64),
                           whole)


def _psum_one_device(g, r, mode):
    """compressed_psum's arithmetic written out on one device."""
    sent, res = [], []
    for i in range(g.shape[0]):
        gi = g[i] + r[i]
        c = dequantize_int8(*quantize_int8(gi)) if mode == "int8" \
            else gi.to(torch.bfloat16)
        sent.append(c)
        res.append(gi - c.float())
    total = sent[0]
    for c in sent[1:]:
        total = total + c
    return total.float() / g.shape[0], torch.stack(res)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compressed_psum(ref, mode):
    g, r = _t(ref["cp_g"]), _t(ref["cp_r"])
    means, efs = compressed_psum([{"w": g[i]} for i in range(4)],
                                 [EFState({"w": r[i]}) for i in range(4)],
                                 mode)
    mean_1, res_1 = _psum_one_device(g, r, mode)
    for i in range(4):
        assert torch.equal(means[i]["w"], mean_1)
        assert torch.equal(efs[i].residual["w"], res_1[i])
    f32_ulp = float((g + r).abs().max()) * 2.0 ** -23
    np.testing.assert_allclose(res_1.numpy(), ref[f"cp_{mode}_res"],
                               rtol=0, atol=f32_ulp)
    ulp = 2.0 ** (-23 if mode == "int8" else -8)
    scale = float(mean_1.abs().max()) * 4
    for i in range(4):
        np.testing.assert_allclose(mean_1.numpy(), ref[f"cp_{mode}_mean"][i],
                                   rtol=0, atol=scale * ulp)
    with pytest.raises(ValueError):
        compressed_psum([{"w": g[0]}], [EFState({"w": r[0]})], "fp8")


def test_remesh_state(ref):
    w, b = _t(ref["rm_w"]), _t(ref["rm_b"])
    state = TrainState({"w": w, "b": b}, {"step": torch.tensor(3)})
    specs = {"w": ("embed", "mlp"), "b": ("mlp",)}
    cur = remesh_state(state, ShardMesh((2, 2), ("data", "model"), CPU4),
                       specs)
    assert cur.params["w"].spec == ("data", "model")
    assert cur.params["b"].spec == ("model",)
    for shape in ((2, 2), (4, 1), (1, 1)):
        n = shape[0] * shape[1]
        mesh = ShardMesh(shape, ("data", "model"), ["cpu"] * n)
        cur = remesh_state(cur, mesh, specs)
        step = cur.opt_state["step"]
        assert step.spec == () and int(step.full()) == 3
        for name, full in (("w", w), ("b", b)):
            leaf = cur.params[name]
            assert isinstance(leaf, shd.Sharded)
            assert torch.equal(leaf.full(), full)
            want = ref["blocks"][f"({shape[0]}, {shape[1]})/{name}"]
            got = []
            for i, shard in enumerate(leaf.shards):
                sl = shd.block_slices(full.shape, leaf.spec, mesh,
                                      shd._coords(mesh, i))
                got.append([i, [[s.start, s.stop] for s in sl],
                            shard.tolist()])
            assert got == want, (shape, name)
