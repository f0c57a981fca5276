"""The port's sharding rules against the JAX package's: every case of
``tests/test_sharding_rules.py``; every parameter leaf of every arch at
full width on the pod and multipod mesh shapes (the port's spec equals
``tuple(jax_pspec)`` less the stacked leading entries, which are
unsharded); a train state's moments by ``state_shardings``; the caches'
axes; the batch layout; and ``constrain``, a no-op without a
``DeviceMesh`` and ``pspec_for``'s layout under one.

The port's models carry one tensor a layer where the reference stacks
them, so ``model.logical_axes()`` drops the stacked prefix; the mapping
is ``interop.port_axes``.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import configs as JC
from repro.dist import sharding as JS
from repro.models.registry import build_model as jax_build
from repro.train.optimizer import adamw as j_adamw
from repro.train.trainstep import TrainState as JState
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.dist import sharding as TS
from repro_torch.dist.mesh import ShardMesh
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import adamw as t_adamw
from repro_torch.train.trainstep import init_state

ARCHS = sorted(JC.ARCHS)


class FakeMesh:
    """Duck-typed mesh: only .shape is consulted by pspec_for."""

    def __init__(self, shape: dict):
        self.shape = shape


POD = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"pod": POD, "multipod": MULTI}
KV = ("layers", "batch", "kv_seq", "kv_heads", None)

# (axes, shape, mesh, rules, want): the cases of tests/test_sharding_rules.py
RULE_CASES = [
    (("embed", "heads"), (4096, 4096), POD, None, P("data", "model")),
    (("embed", "heads"), (4096, 4096), MULTI, None,
     P(("pod", "data"), "model")),
    (KV, (36, 128, 32768, 2, 128), POD, None,
     P(None, "data", "model", None, None)),
    (KV, (30, 128, 32768, 32, 128), POD, None,
     P(None, "data", None, "model", None)),
    (KV, (81, 1, 524288, 32, 112), POD, None,
     P(None, None, "data", "model", None)),
    (("embed", "embed"), (4096, 4096), POD, None, P("data", None)),
    (("batch", "qseq", "heads", None), (32, 32768, 40, 96), POD, "act",
     P("data", "model", None, None)),
    (("batch", "qseq", "heads", None), (32, 32768, 32, 128), POD, "act",
     P("data", None, "model", None)),
    (("batch", "kv_heads", "heads", "qseq", None), (16, 4, 16, 4096, 1024),
     POD, "act", P("data", None, "model", None, None)),
    (("expert", "embed", "mlp"), (128, 4096, 1536), POD, None,
     P("model", "data", None)),
]


@pytest.mark.parametrize("case", range(len(RULE_CASES)))
def test_rule_cases(case):
    axes, shape, mesh, rules, want = RULE_CASES[case]
    jr = JS.ACT_RULES if rules == "act" else None
    tr = TS.ACT_RULES if rules == "act" else None
    got = TS.pspec_for(axes, shape, mesh, tr)
    assert got == tuple(want)
    assert got == tuple(JS.pspec_for(axes, shape, mesh, jr))


def test_rule_tables_and_real_mesh():
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
    assert TS.ACT_RULES == JS.ACT_RULES
    mesh = ShardMesh((1, 1), ("data", "model"), ["cpu"])
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    assert TS.pspec_for(("embed", "mlp"), (64, 128), mesh) == \
        tuple(JS.pspec_for(("embed", "mlp"), (64, 128), jmesh)) == \
        ("data", "model")
    with pytest.raises(ValueError):
        TS.pspec_for(("embed",), (4, 4), mesh)


def _jax_params(arch):
    model = jax_build(JC.get_config(arch))
    cap = {}

    def init(key):
        params, specs = model.init(key)
        cap["specs"] = specs
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return model, shapes, cap["specs"]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


LEAD = {"layers": 1, "groups": 2, "tail": 1}


def _jax_leaf_specs(arch, mesh, shapes, specs):
    """{port name: tuple(jax pspec) without the stacked entries}."""
    cfg = TC.get_config(arch)
    stacked = interop._stacked_axes(cfg)
    spec_of = dict(_flat(specs))
    out = {}
    for name, sds in _flat(shapes):
        full = tuple(JS.pspec_for(spec_of[name], sds.shape, mesh))
        full += (None,) * (len(sds.shape) - len(full))
        key = name.split(".", 1)[0]
        if key not in stacked:
            out[name] = full
            continue
        n = LEAD[key]
        assert full[:n] == (None,) * n, name
        for idx in np.ndindex(*stacked[key][1]):
            out[".".join((key, *map(str, idx), name.split(".", 1)[1]))] = \
                full[n:]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_leaf_at_full_width(arch):
    _, shapes, specs = _jax_params(arch)
    model = build_model(TC.get_config(arch), device="meta")
    axes = model.logical_axes()
    assert axes == interop.port_axes(specs, TC.get_config(arch))
    params = dict(model.named_parameters())
    for mname, mesh in MESHES.items():
        want = _jax_leaf_specs(arch, mesh, shapes, specs)
        got = {n: TS.pspec_for(axes[n], p.shape, mesh)
               for n, p in params.items()}
        assert got == want, mname
        tree = TS.tree_shardings(params, axes, mesh)
        assert tree == got


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b",
                                  "qwen3-moe-235b-a22b", "minicpm3-4b"])
def test_state_shardings_match_moments(arch):
    """A train state's moments take their parameter's spec by the
    trailing dict keys of their path; the step is replicated."""
    jmodel, _, specs = _jax_params(arch)
    opt = j_adamw(1e-3)
    mesh = AbstractMesh((16, 16), ("data", "model"))

    def init(key):
        params, _ = jmodel.init(key)
        return JState(params, opt.init(params))

    state = jax.eval_shape(init, jax.random.PRNGKey(0))
    jsh = JS.state_shardings(state, specs, mesh)
    assert isinstance(jsh.opt_state.step, NamedSharding)
    cfg = TC.get_config(arch)
    model = build_model(cfg, device="meta")
    tstate = init_state(model, t_adamw(1e-3))
    tsh = TS.state_shardings(tstate, model.logical_axes(), POD)
    assert tsh.opt_state.step == ()
    for which in ("mu", "nu"):
        jtree = dict(_flat(jax.tree.map(
            lambda s: tuple(s.spec), getattr(jsh.opt_state, which),
            is_leaf=lambda x: isinstance(x, NamedSharding))))
        got = getattr(tsh.opt_state, which)
        stacked = interop._stacked_axes(cfg)
        for name, spec in got.items():
            key = name.split(".", 1)[0]
            if key in stacked:
                n = LEAD[key]
                parts = name.split(".")
                jname = ".".join([key] + parts[1 + n:])
                full = jtree[jname] + (None,) * 8
                assert spec == full[n:n + len(spec)], name
            else:
                full = jtree[name] + (None,) * 8
                assert spec == full[:len(spec)], name
    assert tsh.params == TS.tree_shardings(tstate.params,
                                           model.logical_axes(), POD)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_cache_axes_equal_reference(arch):
    jm = jax_build(JC.get_config(arch))
    tm = build_model(TC.get_config(arch), device="meta")
    want, got = jm.cache_axes(), tm.cache_axes()
    if isinstance(want, dict):
        assert list(got) == list(want)
        pairs = [(got[k], want[k]) for k in want]
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        assert type(g).__name__ == type(w).__name__
        assert tuple(g) == tuple(w)
    cache = tm.init_cache(4, 64)
    sh = TS.tree_shardings(cache, got, POD)
    flat_c, flat_s = [], []
    TS._map(lambda x, s: (flat_c.append(x), flat_s.append(s)), cache, sh)
    for x, s in zip(flat_c, flat_s):
        assert s == () if not isinstance(x, torch.Tensor) else len(s) == \
            x.dim()


def test_batch_shardings_equal_reference():
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for arch in ("qwen2.5-3b", "internvl2-2b", "hubert-xlarge"):
        for shape in ("train_4k", "prefill_32k"):
            jb = JC.input_specs(JC.get_config(arch), shape)
            tb = TC.input_specs(TC.get_config(arch), shape)
            want = {k: tuple(v.spec)
                    for k, v in JS.batch_shardings(jb, mesh).items()}
            assert TS.batch_shardings(tb, POD) == want


def test_constrain_is_a_no_op():
    """Without a ``DeviceMesh`` (none, or an in-process ``ShardMesh``),
    ``constrain``, ``view``'s layout and ``on_mesh`` return their input
    untouched; under a ``(2, 4)`` ``DeviceMesh`` over a fake group,
    ``constrain`` lays a DTensor out by ``pspec_for``'s placements under
    ``ACT_RULES`` (the divisibility fallback included), and ``on_mesh``
    replicates a plain tensor."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import fake_device_mesh
    x = torch.randn(4, 8)
    assert TS.constrain(x, ("batch", None)) is x
    assert TS.on_mesh(x) is x
    with TS.use_mesh(ShardMesh((2, 2), ("data", "model"), ["cpu"] * 4)):
        assert TS._context_mesh() is not None
        assert TS.constrain(x, ("batch", "heads")) is x
        assert TS.on_mesh(x) is x
    assert TS._context_mesh() is None
    assert TS.replicated(POD) == tuple(P())
    with fake_device_mesh((2, 4), ("data", "model")) as mesh:
        d = distribute_tensor(torch.empty(4, 8, 6, device="meta"), mesh,
                              [Replicate(), Replicate()], src_data_rank=None)
        assert TS.constrain(d, ("batch", None, "heads")) is d  # no mesh
        with TS.use_mesh(mesh):
            for axes in [("batch", None, "heads"), ("batch", "heads", None),
                         (None, "kv_heads", "heads"), ("qseq", None, None)]:
                got = TS.constrain(d, axes)
                spec = TS.pspec_for(axes, d.shape, mesh, TS.ACT_RULES)
                assert isinstance(got, DTensor)
                assert tuple(got.placements) == TS.placements(spec, mesh)
            # 6 heads do not divide 4: the model axis stays unused
            assert TS.constrain(d, ("batch", None, "heads")).placements == \
                (Shard(0), Replicate())
            assert TS.constrain(d, ("batch", "heads", None)).placements == \
                (Shard(0), Shard(1))
            r = TS.on_mesh(torch.empty(3, device="meta"))
            assert isinstance(r, DTensor)
            assert r.placements == (Replicate(), Replicate())
            assert TS.on_mesh(r) is r
