"""The port's measured autotuner against the JAX package's.

The key is the reference's with ``torch_device=cpu|cuda`` in place of
``interpret=``; the candidate set and the skipped list of ``measure``
equal the reference's (winners are timings, so they are not compared);
a cache hit measures nothing; the port keeps its own cache file, which
never holds a JAX entry; ``policy="tuned"`` resolves to the cached
winner.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core import stencil as JS
from repro.engine import tune as JT
from repro.engine.plan import PlanError as JPlanError
from repro_torch import engine as TE
from repro_torch.core import stencil as TS
from repro_torch.engine import tune as TT
from repro_torch.engine.plan import PlanError as TPlanError
from repro_torch.interop import grid_from_numpy, grid_to_numpy
from repro_torch.obs import metrics as TM

SPECS = {"jacobi5": (JS.jacobi_2d_5pt(), TS.jacobi_2d_5pt()),
         "laplace9": (JS.laplace_2d_9pt(), TS.laplace_2d_9pt())}


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' caches in files of their own under tmp_path."""
    paths = {"jax": tmp_path / "jax.json", "torch": tmp_path / "torch.json"}
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(paths["jax"]))
    monkeypatch.setenv(TT.CACHE_ENV, str(paths["torch"]))
    JT.clear()
    TT.clear()
    yield paths
    JT.clear()
    TT.clear()


def _untimed(monkeypatch):
    """Both packages' candidates timed as equal (the sets are compared)."""
    monkeypatch.setattr(JT, "_time_policy", lambda *a, **k: 1.0)
    monkeypatch.setattr(TT, "_time_policy", lambda *a, **k: 1.0)


@pytest.mark.parametrize("device", ["cpu_ref", "gpu_sm90", "grayskull_e150",
                                    "tpu_v5e"])
@pytest.mark.parametrize("cell", [
    dict(shape=(18, 18), t=8, bm=None), dict(shape=(66, 130), t=4, bm=16),
    dict(shape=(1026, 9218), t=None, bm=None, mesh=(2, 2), masked=True,
         overlap=True)])
def test_tune_key_is_the_reference_key_with_the_torch_device(device, cell):
    for name, (js, ts) in SPECS.items():
        for interpret, where in ((True, "cpu"), (False, "cuda")):
            want = JT.tune_key(cell["shape"], jnp.float32, js,
                               JE.get_device(device), interpret=interpret,
                               **{k: v for k, v in cell.items()
                                  if k != "shape"})
            got = TT.tune_key(cell["shape"], torch.float32, ts,
                              TE.get_device(device), torch_device=where,
                              **{k: v for k, v in cell.items()
                                 if k != "shape"})
            assert got == want.replace(f"interpret={interpret}",
                                       f"torch_device={where}")


def _measure_both(shape, spec_name, t, device):
    js, ts = SPECS[spec_name]
    try:
        want = JT.measure(shape, jnp.float32, js, t=t, device=device)
    except JPlanError as e:
        want = e
    try:
        got = TT.measure(shape, torch.float32, ts, t=t, device=device,
                         torch_device="cpu")
    except TPlanError as e:
        got = e
    return want, got


@pytest.mark.parametrize("device", ["cpu_ref", "grayskull_e150", "tpu_v5e"])
@pytest.mark.parametrize("shape", [(18, 18), (66, 130), (258, 1026),
                                   (130, 4098), (34, 16386)])
def test_measure_candidates_and_skips_equal_the_reference(
        caches, monkeypatch, device, shape):
    _untimed(monkeypatch)
    for spec_name in SPECS:
        for t in (4, 8):
            want, got = _measure_both(shape, spec_name, t, device)
            if isinstance(want, Exception):
                assert isinstance(got, Exception) and str(got) == str(want)
                continue
            assert set(got["us_per_sweep"]) == set(want["us_per_sweep"])
            assert got["skipped"] == want["skipped"]
            assert got["device"] == want["device"]


def test_measure_candidates_on_gpu_sm90(caches, monkeypatch):
    """On gpu_sm90 the sets are the reference's where its row blocks fit
    the 227 KiB of shared memory; wider, the port's 2-D tiles plan every
    candidate the reference's rows cannot (ROADMAP Queue 3)."""
    _untimed(monkeypatch)
    for spec_name in SPECS:
        want, got = _measure_both((18, 18), spec_name, 8, "gpu_sm90")
        assert set(got["us_per_sweep"]) == set(want["us_per_sweep"])
        assert got["skipped"] == want["skipped"] == []
        want, got = _measure_both((66, 130), spec_name, 8, "gpu_sm90")
        assert want["skipped"] == ["shifted"] and got["skipped"] == []
        want, got = _measure_both((1026, 9218), spec_name, 8, "gpu_sm90")
        assert isinstance(want, JPlanError)
        assert set(got["us_per_sweep"]) == {"shifted", "rowchunk", "dbuf",
                                            "temporal"}


def test_measure_times_the_plain_versions_on_cpu(caches):
    before = TT.cache_info()["measure_count"]
    rec = TT.measure((18, 34), torch.float32, TS.jacobi_2d_5pt(), t=4,
                     device="cpu_ref", torch_device="cpu")
    assert TT.cache_info()["measure_count"] == before + 1
    assert rec["policy"] in rec["us_per_sweep"]
    assert set(rec["us_per_sweep"]) == {"shifted", "rowchunk", "dbuf",
                                        "temporal"}
    assert all(us > 0 for us in rec["us_per_sweep"].values())
    assert rec["policy"] == min(rec["us_per_sweep"],
                                key=rec["us_per_sweep"].get)


def test_a_hit_measures_nothing(caches):
    spec = TS.jacobi_2d_5pt()
    hits = TM.counter("engine.tune.hit").value
    first = TT.best_policy((18, 18), torch.float32, spec, iters=16, t=8,
                           torch_device="cpu")
    count = TT.cache_info()["measure_count"]
    for _ in range(3):
        assert TT.best_policy((18, 18), torch.float32, spec, iters=16, t=8,
                              torch_device="cpu") == first
    assert TT.cache_info()["measure_count"] == count
    assert TM.counter("engine.tune.hit").value == hits + 3
    TT.clear()  # the file answers a fresh process
    assert TT.best_policy((18, 18), torch.float32, spec, iters=16, t=8,
                          torch_device="cpu") == first
    assert TT.cache_info()["measure_count"] == count


def test_warm_is_idempotent(caches):
    shapes = [(18, 18), (14, 22)]
    won = TT.warm(shapes, torch.float32, TS.jacobi_2d_5pt(), iters=8, t=4,
                  torch_device="cpu")
    assert set(won) == set(shapes)
    count = TT.cache_info()["measure_count"]
    assert TT.warm(shapes, torch.float32, TS.jacobi_2d_5pt(), iters=8, t=4,
                   torch_device="cpu") == won
    assert TT.cache_info()["measure_count"] == count


def test_the_port_file_never_holds_a_jax_entry(caches, monkeypatch):
    _untimed(monkeypatch)
    js, ts = SPECS["jacobi5"]
    JT.best_policy((18, 18), jnp.float32, js, iters=16, t=8)
    TT.best_policy((18, 18), torch.float32, ts, iters=16, t=8,
                   torch_device="cpu")
    jax_keys = json.loads(caches["jax"].read_text())
    port_keys = json.loads(caches["torch"].read_text())
    assert len(jax_keys) == len(port_keys) == 1
    assert all("interpret=" in k and "torch_device=" not in k
               for k in jax_keys)
    assert all("torch_device=cpu" in k and "interpret=" not in k
               for k in port_keys)
    # Without its own variable the port uses its own default path, never
    # the reference's variable or file.
    default = TT.DEFAULT_CACHE_PATH
    assert default != JT.DEFAULT_CACHE_PATH
    assert default.split("/")[-2:] == ["repro_torch", "engine_tune.json"]
    monkeypatch.delenv(TT.CACHE_ENV)
    own = caches["torch"].parent / "home" / "engine_tune.json"
    monkeypatch.setattr(TT, "DEFAULT_CACHE_PATH", str(own))
    TT.clear()
    TT.best_policy((18, 18), torch.float32, ts, iters=16, t=8,
                   torch_device="cpu")
    assert own.exists()
    assert json.loads(caches["jax"].read_text()) == jax_keys


def _seed(path, key, policy):
    path.write_text(json.dumps({key: {"policy": policy, "us_per_sweep": {},
                                      "skipped": [], "device": "cpu_ref"}}))


@pytest.mark.parametrize("winner", ["dbuf", "rowchunk", "shifted"])
def test_tuned_resolves_to_a_seeded_entry(caches, winner):
    spec = TS.jacobi_2d_5pt()
    key = TT.tune_key((18, 18), torch.float32, spec, TE.get_device(None),
                      t=8, bm=None, torch_device="cpu")
    _seed(caches["torch"], key, winner)
    count = TT.cache_info()["measure_count"]
    sched = TE.build_schedule(16, spec=spec, shape=(18, 18),
                              dtype=torch.float32, policy="tuned", t=8,
                              torch_device="cpu")
    assert sched.policy == winner
    u = TS.make_laplace_problem(16, 16, device="cpu")
    assert torch.equal(TE.run(u, spec, policy="tuned", iters=16, t=8),
                       TE.run(u, spec, policy=winner, iters=16, t=8))
    assert TT.cache_info()["measure_count"] == count
    # a single step never fuses: tuned resolves as auto does there
    assert torch.equal(TE.step(u, spec, policy="tuned"),
                       TE.step(u, spec, policy="auto"))


def test_tuned_run_matches_the_reference_under_the_same_winner(caches):
    js, ts = SPECS["laplace9"]
    jkey = JT.tune_key((18, 18), jnp.float32, js, JE.get_device(None), t=8,
                       bm=None, interpret=True)
    tkey = TT.tune_key((18, 18), torch.float32, ts, TE.get_device(None),
                       t=8, bm=None, torch_device="cpu")
    _seed(caches["jax"], jkey, "rowchunk")
    _seed(caches["torch"], tkey, "rowchunk")
    rng = np.random.default_rng(0)
    a = np.zeros((18, 18), np.float32)
    a[:, 0] = 1.0
    a[1:-1, 1:-1] = rng.uniform(0, 1, (16, 16))
    want = JE.run(jnp.asarray(a), js, policy="tuned", iters=16, t=8,
                  interpret=True)
    got = TE.run(grid_from_numpy(a, device="cpu"), ts, policy="tuned",
                 iters=16, t=8)
    np.testing.assert_allclose(grid_to_numpy(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
