"""The JAX side of ``tests/test_torch_c2.py`` and
``tests/test_torch_c2_process.py``: one subprocess a test run, with 4
forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
as ``tests/test_pipeline.py`` and ``tests/test_ssm_sp.py`` run, at their
shapes, on inputs drawn with numpy from a seed and written beside its
results. Both files, and pytest-xdist's workers, share the one run
through a lock in the run's temporary root.
"""
import fcntl
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist._compat import shard_map
from repro.launch.mesh import make_mesh
out = {}
rng = np.random.default_rng(0)

# pipeline: tests/test_pipeline.py's shapes
from repro.dist.pipeline import pipeline_forward, split_stages
L, D, M, MB, S = 8, 32, 6, 4, 4
w = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
x = rng.standard_normal((M, MB, D)).astype(np.float32)
out["pipe_w"], out["pipe_x"] = w, x
def stage_fn(pl, h):
    def body(c, wi):
        return jnp.tanh(c @ wi), None
    return jax.lax.scan(body, h, pl["w"])[0]
pipe = jax.jit(pipeline_forward(stage_fn, make_mesh((S,), ("stage",))))
sp = split_stages({"w": jnp.asarray(w)}, S)
out["pipe_y"] = np.asarray(pipe(sp, jnp.asarray(x)))
out["pipe_g"] = np.asarray(jax.grad(
    lambda p: jnp.sum(pipe(p, jnp.asarray(x)) ** 2))(sp)["w"]).reshape(L, D, D)

# sequence-parallel SSD and conv halo: tests/test_ssm_sp.py's shapes
from repro.core.ssm_sp import ssd_sequence_parallel, conv_halo_exchange
B, L2, G, Mh, Pd, N, CH = 2, 256, 1, 4, 8, 16, 32
xs = rng.standard_normal((B, L2, G, Mh, Pd)).astype(np.float32)
dt = np.log1p(np.exp(rng.standard_normal((B, L2, G, Mh)))).astype(np.float32)
a = (-np.exp(rng.standard_normal((G, Mh)) * 0.3)).astype(np.float32)
bm = (rng.standard_normal((B, L2, G, N)) * 0.3).astype(np.float32)
cm = (rng.standard_normal((B, L2, G, N)) * 0.3).astype(np.float32)
out.update(ssd_x=xs, ssd_dt=dt, ssd_a=a, ssd_b=bm, ssd_c=cm)
mesh = make_mesh((4,), ("sp",))
f = shard_map(lambda x_, d_, b_, c_: ssd_sequence_parallel(
    x_, d_, jnp.asarray(a), b_, c_, CH, "sp", 4), mesh=mesh,
    in_specs=(P(None, "sp"),) * 4, out_specs=P(None, "sp"), check_vma=False)
out["ssd_y"] = np.asarray(jax.jit(f)(xs, dt, bm, cm))
K, C = 4, 32
xc = rng.standard_normal((B, L2, C)).astype(np.float32)
wc = (rng.standard_normal((K, C)) * 0.5).astype(np.float32)
out["conv_x"], out["conv_w"] = xc, wc
def conv_local(xl):
    ext = conv_halo_exchange(xl, K, "sp", 4)
    o = jnp.zeros(xl.shape, jnp.float32)
    for i in range(K):
        o = o + ext[:, i:i + xl.shape[1], :] * wc[i]
    return o.astype(xl.dtype)
out["conv_y"] = np.asarray(jax.jit(shard_map(
    conv_local, mesh=mesh, in_specs=(P(None, "sp"),),
    out_specs=P(None, "sp"), check_vma=False))(xc))

# sharded flash attention on a (2, 2) data x model mesh
from repro.dist.sharding import use_mesh
from repro.kernels.ops import flash_attention
q = rng.standard_normal((2, 128, 4, 32)).astype(np.float32)
k = rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
v = rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
out.update(fa_q=q, fa_k=k, fa_v=v)
with use_mesh(make_mesh((2, 2), ("data", "model"))):
    out["fa_y"] = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        bq=64, bk=64))

# compressed all-reduce over 4 replicas
from repro.train.compression import EFState, compressed_psum
g = rng.standard_normal((4, 16, 8)).astype(np.float32)
r = (rng.standard_normal((4, 16, 8)) * 1e-3).astype(np.float32)
out["cp_g"], out["cp_r"] = g, r
dp = make_mesh((4,), ("dp",))
for mode in ("int8", "bf16"):
    def one(gl, rl):
        mean, ef = compressed_psum({"w": gl[0]}, EFState({"w": rl[0]}),
                                   "dp", mode)
        return mean["w"][None], ef.residual["w"][None]
    m_, r_ = jax.jit(shard_map(one, mesh=dp, in_specs=(P("dp"), P("dp")),
                               out_specs=(P("dp"), P("dp")),
                               check_vma=False))(g, r)
    out[f"cp_{mode}_mean"], out[f"cp_{mode}_res"] = np.asarray(m_), np.asarray(r_)

# remesh: blocks of each leaf on each device
from repro.train.fault import remesh_state
from repro.train.trainstep import TrainState
state = TrainState(
    {"w": rng.standard_normal((8, 16)).astype(np.float32),
     "b": rng.standard_normal((16,)).astype(np.float32)},
    {"step": np.int32(3)})
specs = {"w": ("embed", "mlp"), "b": ("mlp",)}
out["rm_w"], out["rm_b"] = state.params["w"], state.params["b"]
blocks = {}
for shape, axes in (((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
                    ((1, 1), ("data", "model")), ((2,), ("data",))):
    new = remesh_state(state, make_mesh(shape, axes), specs, None)
    ids = {d: i for i, d in enumerate(jax.devices())}
    for name in ("w", "b"):
        leaf = new.params[name]
        blocks[f"{shape}/{name}"] = sorted(
            (ids[s.device], [[sl.start or 0, sl.stop] for sl in
                             [slice(x.start, x.stop if x.stop is not None
                              else leaf.shape[i]) for i, x in
                              enumerate(s.index)]], np.asarray(s.data).tolist())
            for s in leaf.addressable_shards)
np.savez(sys.argv[1], **out)
json.dump(blocks, open(sys.argv[2], "w"))
print("C2 JAX OK")
"""



def reference(tmp_path_factory) -> dict:
    """The JAX script's arrays (inputs and results) by name, its remesh
    blocks under ``"blocks"`` and the path of its ``.npz`` under
    ``"npz"``; the script runs once a test run, whichever file asks
    first."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's root, shared by the workers
    out_dir = root / "c2_jax"
    with open(root / "c2_jax.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out_dir / "done").exists():
            out_dir.mkdir(exist_ok=True)
            env = dict(os.environ)
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
            env["PYTHONPATH"] = os.path.join(REPO, "src")
            proc = subprocess.run(
                [sys.executable, "-c", SCRIPT, str(out_dir / "o.npz"),
                 str(out_dir / "blocks.json")], env=env,
                capture_output=True, text=True, timeout=600)
            assert proc.returncode == 0, proc.stderr[-3000:]
            assert "C2 JAX OK" in proc.stdout
            (out_dir / "done").write_text("")
    out = dict(np.load(out_dir / "o.npz"))
    out["blocks"] = json.loads((out_dir / "blocks.json").read_text())
    out["npz"] = str(out_dir / "o.npz")
    return out
