"""The port's hybrid (zamba2) serving against the JAX ServeEngine on the
CPU.

zamba2 at smoke size, in f32 compute, with ``ssm_conv_impl="pallas"`` and
``attn_impl="flash"`` at ``attn_chunk`` 16, so a 32-token prefill runs the
shared block's attention through K8 and every mamba layer's conv through
K7 (their plain versions here, the Pallas kernels in interpret mode
there): both engines serve the same requests from the same weights, and
their greedy tokens must be equal.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models.base import ModelConfig as JaxModelConfig
from repro.models.registry import build_model as jax_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.models.hybrid import HybridLM
from repro_torch.serve.engine import Request, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
ARCH = "zamba2-7b"
KNOBS = dict(ssm_conv_impl="pallas", attn_impl="flash", attn_chunk=16)


@dataclasses.dataclass(frozen=True)
class JaxCfg(JaxModelConfig):
    """The JAX config with the conv switch its ssm layer reads."""
    ssm_conv_impl: str = "jnp"


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model), f32 zamba2 smoke."""
    jc = JC.get_smoke_config(ARCH)
    jcfg = JaxCfg(**{f.name: getattr(jc, f.name)
                     for f in dataclasses.fields(jc)})
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, **KNOBS)
    tcfg = dataclasses.replace(TC.get_smoke_config(ARCH),
                               dtype=torch.float32, **KNOBS)
    jmodel = jax_build(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    tmodel = interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    return jmodel, params, tmodel


def _prompts(n, vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=lens[i % len(lens)], dtype=np.int32)
            for i in range(n)]


def test_greedy_tokens_equal_jax_engine_two_waves(pair):
    """Two waves of two; the second wave left-pads a 20-token prompt to 32
    (a multiple of the smoke chunk, 16); max_new_tokens differ."""
    jmodel, params, tmodel = pair
    assert isinstance(tmodel, HybridLM)
    prompts = _prompts(4, 512, [32, 32, 32, 20])
    max_new = [5, 3, 4, 6]
    want = JEngine(jmodel, params, batch_size=2, max_len=48).generate(
        [JRequest(prompt=p, max_new_tokens=m)
         for p, m in zip(prompts, max_new)])
    got = ServeEngine(tmodel, batch_size=2, max_len=48).generate(
        [Request(prompt=p, max_new_tokens=m)
         for p, m in zip(prompts, max_new)])
    assert [len(r.generated) for r in got] == max_new
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(r.done for r in got)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", ARCH, "--smoke", *args],
                          cwd=ROOT, env=ENV, capture_output=True, text=True,
                          timeout=300)


def test_cli_serves_on_cpu():
    res = _cli("--device", "cpu", "--requests", "3", "--batch", "2",
               "--prompt-len", "16", "--max-new", "4")
    assert res.returncode == 0, res.stderr
    assert "arch=zamba2-7b-smoke device=cpu requests=3 new_tokens=12" \
        in res.stdout


def test_cli_without_device_cpu_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI default runs on it")
    res = _cli("--requests", "1", "--max-new", "2")
    assert res.returncode != 0
    assert "cuda" in res.stderr and "tok/s" not in res.stdout
