"""The port's LM serving against the JAX ServeEngine on the CPU.

At smoke size, in f32 compute, with 64-token prompts and
``attn_chunk=16`` (so prefill takes the long path: the flash kernel's
plain version here, the Pallas kernel in interpret mode there), both
engines serve the same requests from the same weights, and their greedy
tokens must be equal.
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
from repro.models.registry import build_model as jax_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import sample

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model) for f32 qwen smoke with flash."""
    kw = dict(attn_chunk=16, attn_impl="flash")
    jcfg = dataclasses.replace(JC.get_smoke_config("qwen2.5-3b"),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(TC.get_smoke_config("qwen2.5-3b"),
                               dtype=torch.float32, **kw)
    jmodel = jax_build(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    tmodel = interop.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    return jmodel, params, tmodel


def _prompts(n, vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=lens[i % len(lens)], dtype=np.int32)
            for i in range(n)]


def _serve_both(pair, prompts, max_new, eos=None):
    jmodel, params, tmodel = pair
    jeng = JEngine(jmodel, params, batch_size=2, max_len=80, eos_id=eos)
    teng = ServeEngine(tmodel, batch_size=2, max_len=80, eos_id=eos)
    jreqs = [JRequest(prompt=p, max_new_tokens=m)
             for p, m in zip(prompts, max_new)]
    treqs = [Request(prompt=p, max_new_tokens=m)
             for p, m in zip(prompts, max_new)]
    return jeng.generate(jreqs), teng.generate(treqs)


def test_greedy_tokens_equal_jax_engine_two_waves(pair):
    """Two waves of two; the second wave left-pads a 40-token prompt to 64;
    max_new_tokens differ within each wave."""
    prompts = _prompts(4, 512, [64, 64, 64, 40])
    want, got = _serve_both(pair, prompts, [5, 3, 4, 6])
    assert [len(r.generated) for r in got] == [5, 3, 4, 6]
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(r.done for r in got)


def test_eos_stops_a_request(pair):
    prompts = _prompts(2, 512, [64], seed=1)
    _, free = _serve_both(pair, prompts, [6, 6])
    eos = free[0].generated[2]
    want, got = _serve_both(pair, prompts, [6, 6], eos=eos)
    assert [r.generated for r in got] == [r.generated for r in want]
    first = free[0].generated.index(eos)
    assert got[0].generated == free[0].generated[:first + 1]


def test_temperature_sampling_is_deterministic_and_in_range(pair):
    _, _, tmodel = pair
    prompts = _prompts(2, 512, [64], seed=2)
    runs = []
    for _ in range(2):
        eng = ServeEngine(tmodel, batch_size=2, max_len=80,
                          generator=torch.Generator().manual_seed(7))
        reqs = [Request(prompt=p, max_new_tokens=8, temperature=t)
                for p, t in zip(prompts, (1.5, 0.0))]
        runs.append([r.generated for r in eng.generate(reqs)])
    assert runs[0] == runs[1]
    padded = tmodel.cfg.padded_vocab
    assert all(0 <= t < padded for gen in runs[0] for t in gen)
    greedy = ServeEngine(tmodel, batch_size=2, max_len=80).generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
    assert runs[0][1] == greedy[1].generated  # temperature 0 is greedy


def test_sample_greedy_and_hot_rows():
    logits = torch.tensor([[0.0, 5.0, 1.0], [0.0, 0.0, 50.0],
                           [3.0, 3.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    ids = sample(gen, logits, torch.tensor([0.0, 1.0, 0.0]))
    assert ids.dtype == torch.int32
    assert ids.tolist() == [1, 2, 0]  # argmax (first of ties); a sure draw
    draws = {int(sample(gen, torch.zeros(1, 4), torch.tensor([1.0]))[0])
             for _ in range(64)}
    assert draws == {0, 1, 2, 3}


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", "qwen2.5-3b", "--smoke", *args],
                          cwd=ROOT, env=ENV, capture_output=True, text=True,
                          timeout=300)


def test_cli_serves_on_cpu():
    res = _cli("--device", "cpu", "--requests", "3", "--batch", "2",
               "--prompt-len", "12", "--max-new", "4")
    assert res.returncode == 0, res.stderr
    assert "device=cpu requests=3 new_tokens=12" in res.stdout


def test_cli_without_device_cpu_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI default runs on it")
    res = _cli("--requests", "1", "--max-new", "2")
    assert res.returncode != 0
    assert "cuda" in res.stderr and "tok/s" not in res.stdout
