"""The JAX side of ``tests/test_torch_partition.py``: one subprocess a test
run, with 8 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), compiling the
partitioned programs on a ``(2, 4)`` mesh over ``("data", "model")`` and
reading them with the reference's ``analyze_hlo``:

* the reference test's 6-layer relu MLP (``tests/test_hlo_analysis.py``,
  unrolled) with its shardings;
* smoke cells as the reference's dry run lowers a cell
  (``repro.launch.dryrun.lower_cell``: ``in_shardings`` from the rule
  tables, the step under ``with mesh:``), at
  ``tests/test_torch_roofline.py``'s batch (B 4, S 64, two microbatches
  for train) and tuning.

It writes each program's per-device dot FLOPs and collective bytes by op
to a JSON file. The file's tests, and pytest-xdist's workers, share the
one run through a lock in the run's temporary root.
"""
import fcntl
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Mesh of the comparison: ``(2, 4)`` over ``("data", "model")``.
MESH = ((2, 4), ("data", "model"))
B, S, ACC = 4, 64, 2
#: The smoke cells both sides count, ``(arch, kind)``: one arch of each
#: family, train, prefill and decode where the family has them.
CELLS = [(arch, kind)
         for arch in ("qwen2.5-3b", "qwen3-moe-30b-a3b", "minicpm3-4b",
                      "internvl2-2b", "mamba2-2.7b", "zamba2-7b",
                      "hubert-xlarge")
         for kind in ("train", "prefill", "decode")
         if not (arch == "hubert-xlarge" and kind == "decode")]

SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.dist import sharding as shd
from repro.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model
from repro.train.optimizer import adamw, warmup_cosine
from repro.train.trainstep import TrainState, make_train_step

shape, axes, B, S, ACC, cells = json.loads(sys.argv[2])
mesh = make_mesh(tuple(shape), tuple(axes))
n_dev = mesh.size
out = {}

def record(compiled):
    la = analyze_hlo(compiled.as_text(), n_dev)
    return {"dot_flops": la.dot_flops,
            "collective_bytes": la.collective_bytes,
            "collective_by_op": la.collective_by_op,
            "collective_count": la.collective_count}

# (a) the reference test's MLP, unrolled, with its shardings
def f_unroll(w, w2, x):
    c = x
    for i in range(6):
        c = jax.nn.relu(c @ w[i]) @ w2[i]
    return c.sum()
sds = (jax.ShapeDtypeStruct((6, 256, 512), jnp.float32),
       jax.ShapeDtypeStruct((6, 512, 256), jnp.float32),
       jax.ShapeDtypeStruct((8, 256), jnp.float32))
shs = (NamedSharding(mesh, P(None, "data", "model")),
       NamedSharding(mesh, P(None, "model", "data")),
       NamedSharding(mesh, P(None, "data")))
out["mlp"] = record(jax.jit(f_unroll, in_shardings=shs).lower(*sds)
                    .compile())

# (b) smoke cells, lowered as repro.launch.dryrun.lower_cell does
def batch_sds(cfg, kind):
    i32, bf16 = jnp.int32, jnp.bfloat16
    b = {}
    if cfg.family == "encoder":
        b["features"] = jax.ShapeDtypeStruct((B, S, cfg.audio_feat_dim), bf16)
    else:
        s = S - (cfg.vlm_image_tokens if cfg.family == "vlm" else 0)
        b["tokens"] = jax.ShapeDtypeStruct((B, 1 if kind == "decode" else s),
                                           i32)
        if cfg.family == "vlm" and kind != "decode":
            b["image_embeds"] = jax.ShapeDtypeStruct(
                (B, cfg.vlm_image_tokens, cfg.vlm_vision_dim), bf16)
    if kind == "train":
        n = b["tokens"].shape[1] if "tokens" in b else S
        b["labels"] = jax.ShapeDtypeStruct((B, n), i32)
    return b

for arch, kind in cells:
    cfg = configs.get_smoke_config(arch)
    cfg = dataclasses.replace(
        cfg, remat="full" if kind == "train" else "none",
        **({} if kind == "train" else {"param_dtype": jnp.bfloat16}))
    model = build_model(cfg)
    batch = batch_sds(cfg, kind)
    batch_sh = shd.batch_shardings(batch, mesh)
    captured = {}
    def init_params(key):
        params, specs = model.init(key)
        captured["specs"] = specs
        return params
    params = jax.eval_shape(init_params, jax.random.PRNGKey(0))
    specs = captured["specs"]
    with mesh:
        if kind == "train":
            opt = adamw(warmup_cosine(3e-4, 2000, 100_000))
            step = make_train_step(model, opt, ACC)
            state = jax.eval_shape(lambda p: TrainState(p, opt.init(p)),
                                   params)
            state_sh = shd.state_shardings(state, specs, mesh)
            metrics = jax.eval_shape(step, state, batch)[1]
            metrics_sh = jax.tree.map(lambda _: shd.replicated(mesh), metrics)
            fn = jax.jit(step, in_shardings=(state_sh, batch_sh),
                         out_shardings=(state_sh, metrics_sh),
                         donate_argnums=(0,))
            lowered = fn.lower(state, batch)
        elif kind == "prefill":
            params_sh = shd.tree_shardings(params, specs, mesh)
            fn = jax.jit(lambda p, b: model.forward(p, b, last_only=True)[0],
                         in_shardings=(params_sh, batch_sh))
            lowered = fn.lower(params, batch)
        else:
            params_sh = shd.tree_shardings(params, specs, mesh)
            cache = jax.eval_shape(lambda: model.init_cache(B, S))
            cache_sh = shd.tree_shardings(cache, model.cache_axes(), mesh)
            fn = jax.jit(lambda p, c, b: model.forward(p, b, c)[:2],
                         in_shardings=(params_sh, cache_sh, batch_sh),
                         out_shardings=(None, cache_sh), donate_argnums=(1,))
            lowered = fn.lower(params, cache, batch)
        out[f"{arch}/{kind}"] = record(lowered.compile())
json.dump(out, open(sys.argv[1], "w"), indent=1)
print("PARTITION JAX OK")
"""


def run(path: str, cells=CELLS) -> None:
    """Run the script into ``path`` (JSON)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    arg = json.dumps([*MESH, B, S, ACC, [list(c) for c in cells]])
    proc = subprocess.run([sys.executable, "-c", SCRIPT, path, arg],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PARTITION JAX OK" in proc.stdout


def reference(tmp_path_factory) -> dict:
    """The JAX counts by program (``"mlp"``, ``"<arch>/<kind>"``); the
    script runs once a test run, whichever test asks first."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's root, shared by the workers
    path = root / "partition_jax.json"
    with open(root / "partition_jax.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            run(str(path) + ".part")
            os.replace(str(path) + ".part", path)
    return json.loads(path.read_text())
