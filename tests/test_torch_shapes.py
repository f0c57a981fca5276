"""The port's shape cells and execution knobs against the JAX package's:
``SHAPES``, ``cell_supported`` for every arch x shape, ``input_specs``'
shapes and dtypes (``meta`` tensors where the reference has
``ShapeDtypeStruct`` s), ``tuned``'s config and knobs on both production
mesh shapes, and the production meshes themselves (``meta`` shards, no
card asked for)."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro.configs import shapes as JS
from repro.launch import tuning as JT
from repro_torch import configs as TC
from repro_torch.configs import shapes as TS
from repro_torch.launch import mesh as TM
from repro_torch.launch import tuning as TT

ARCHS = sorted(JC.ARCHS)
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {"pod": FakeMesh({"data": 16, "model": 16}),
          "multipod": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def test_shape_cells_equal_reference():
    assert list(TS.SHAPES) == list(JS.SHAPES)
    for name in JS.SHAPES:
        assert dataclasses.asdict(TS.SHAPES[name]) == \
            dataclasses.asdict(JS.SHAPES[name])
    assert TC.SHAPES is TS.SHAPES and TC.input_specs is TS.input_specs
    assert TC.all_cells() == JC.all_cells()


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_supported_and_input_specs(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for shape in JS.SHAPES:
        assert TS.cell_supported(tcfg, shape) == \
            JS.cell_supported(jcfg, shape)
        want = JS.input_specs(jcfg, shape)
        got = TS.input_specs(tcfg, shape)
        assert list(got) == list(want)
        for name, spec in want.items():
            t = got[name]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(spec.shape), (shape, name)
            assert t.dtype == DTYPES[jnp.dtype(spec.dtype)], (shape, name)


def _cfg_fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out.pop("ssm_conv_impl", None)  # the port's own knob
    return {k: (_dtype_name(v) if k in ("dtype", "param_dtype") else v)
            for k, v in out.items()}


def _dtype_name(v) -> str:
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    return jnp.dtype(v).name


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tuned_config_and_knobs(mesh):
    m = MESHES[mesh]
    assert TT.dp_size(m) == JT.dp_size(m)
    for arch in ARCHS:
        for shape in JS.SHAPES:
            jcfg, jk = JT.tuned(JC.get_config(arch), shape, m)
            tcfg, tk = TT.tuned(TC.get_config(arch), shape, m)
            assert dataclasses.asdict(tk) == dataclasses.asdict(jk)
            assert _cfg_fields(tcfg) == _cfg_fields(jcfg), (arch, shape)
    assert TT.OVERRIDES == JT.OVERRIDES
    assert TT.torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        TT.torch_dtype("matmul")


def test_production_meshes_hold_no_storage():
    pod = TM.make_production_mesh()
    multi = TM.make_production_mesh(multi_pod=True)
    assert pod.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert len(multi.devices) == 512
    assert {d.type for d in (*pod.devices, *multi.devices)} == {"meta"}
    small = TM.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert small.shape == {"data": 2, "model": 2}
    assert small.device(data=1, model=0) == torch.device("cpu")
