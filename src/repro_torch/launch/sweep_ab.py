"""K1–K4 and the main path against another checkout's, on one card.

    python -m repro_torch.launch.sweep_ab --other PATH [--rounds N]

Times K1 (``stencil_temporal``, t = 8), K2 (``stencil_rowchunk``), K3
(``stencil_dbuf``) and K4 (``stencil_shifted``) of this checkout
and of another one (another checkout of this repository, such as a parent
commit unpacked with ``git archive``) on the paper's grid, 1026 x 9218 with
the 5-point spec, in bf16 and f32, with ``torch.nn.functional.conv2d`` on
the same grid and ``Tensor.copy_`` of the grid into the output (the same
bytes moved, no sums) beside them as yardsticks. Each checkout runs in a
process of its own that imports its own ``repro_torch`` and calls only the
public policy functions, which every checkout has, in turns: other, this,
this, other for each round. A process prints, per kernel and dtype, the
device time of a call warm (``obs.timing.device_ms``: calls back to back on
one input and output, which fit the 50 MB L2 together) and cold
(:func:`cold_ms`: the calls rotate over input/output pairs of at least
three times the L2, so no call finds its operands there), and a digest of
its output on a seeded grid. The digests must agree across checkouts (both
compute the same f32 operations, bit for bit). It also times the main
path, ``engine.run(make_laplace_problem(1024, 9216), policy="auto",
iters=1003)`` (one call, device time, warm only), and prints its digest
and subnormal cells without gating them: two checkouts may flush a
diffusion front's subnormal tail differently. Exits non-zero without a
card, or if the kernels' digests differ.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import pathlib
import subprocess
import sys

import torch

#: The H100's L2 cache in bytes; a cold rotation spans three times it.
L2_BYTES = 50 * 2 ** 20
NY, NX = 1024, 9216


def cold_pairs(u: torch.Tensor, out: torch.Tensor | None = None,
               span: int = 3 * L2_BYTES) -> list:
    """Copies of ``u`` (and of ``out``, when given) enough to span ``span``
    bytes together: [(u_i, out_i)], or [(u_i,)] without ``out``."""
    each = u.nbytes + (out.nbytes if out is not None else 0)
    n = max(2, -(-span // each) + 1)
    return [(u.clone(),) if out is None else (u.clone(), out.clone())
            for _ in range(n)]


def cold_ms(call, pairs: list, *, reps: int = 7) -> float:
    """Median device milliseconds of ``call(*pair)`` when no call finds its
    operands in the L2: each call takes the next of ``pairs``
    (:func:`cold_pairs`), so the others, three times the L2 together, have
    passed through it since that pair's last call."""
    from repro_torch.obs.timing import device_ms
    it = itertools.cycle(pairs)
    return device_ms(lambda: call(*next(it)), reps=reps,
                     inner=2 * len(pairs))


def _child() -> None:
    """Time the ``repro_torch`` on ``sys.path`` (one checkout's) and print
    one JSON line."""
    from repro_torch import engine
    from repro_torch.core.stencil import jacobi_2d_5pt, make_laplace_problem
    from repro_torch.obs.timing import device_ms
    torch.backends.cudnn.allow_tf32 = False
    spec = jacobi_2d_5pt()
    g = torch.Generator(device="cuda").manual_seed(7)
    res = {}
    for dname in ("bfloat16", "float32"):
        u = torch.rand((NY + 2, NX + 2), generator=g, device="cuda").to(
            getattr(torch, dname))
        out = torch.empty_like(u)
        engine.policies.copy_ring(u, out, 1)
        pairs = cold_pairs(u, out)
        w = torch.zeros((1, 1, 3, 3), dtype=u.dtype, device="cuda")
        for (dy, dx), wt in zip(spec.offsets, spec.weights):
            w[0, 0, dy + 1, dx + 1] = wt

        def conv(x, _=None):
            return torch.nn.functional.conv2d(x[None, None], w)

        def copy(x, o):
            return o.copy_(x)
        for name in ("temporal", "rowchunk", "dbuf", "shifted", "conv2d",
                     "copy_"):
            if name == "conv2d":
                call = conv
            elif name == "copy_":
                call = copy
            else:
                fn = getattr(engine, f"stencil_{name}")
                kw = {"t": 8} if name == "temporal" else {}

                def call(x, o, fn=fn, kw=kw):
                    return fn(x, spec, out=o, **kw)
            got = call(u, out)
            torch.cuda.synchronize()
            # The yardsticks are timed only (conv2d may pick its algorithm
            # anew in each process); the kernels' outputs must agree.
            digest = None if name in ("conv2d", "copy_") else hashlib.sha256(
                got.float().cpu().numpy().tobytes()).hexdigest()[:16]
            res[f"{name} {dname}"] = {
                "warm_ms": device_ms(lambda: call(u, out)),
                "cold_ms": cold_ms(call, pairs), "digest": digest}
        del pairs
        u0 = make_laplace_problem(NY, NX, dtype=getattr(torch, dname))
        got = engine.run(u0, spec, policy="auto", iters=1003)
        x = got.float()
        res[f"main {dname}"] = {
            "warm_ms": device_ms(lambda: engine.run(u0, spec, policy="auto",
                                                    iters=1003),
                                 reps=5, inner=1),
            "cold_ms": float("nan"), "digest": None,
            "main_digest": hashlib.sha256(
                x.cpu().numpy().tobytes()).hexdigest()[:16],
            "subnormal_cells": int(((x != 0) & (
                x.abs() < torch.finfo(torch.float32).tiny)).sum())}
        torch.cuda.empty_cache()
    print(json.dumps(res))


def _run(tree: pathlib.Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    got = subprocess.run([sys.executable, __file__, "--child"], env=env,
                         capture_output=True, text=True, timeout=600)
    if got.returncode != 0:
        raise SystemExit(f"sweep_ab: {tree} failed:\n{got.stderr[-4000:]}")
    return json.loads(got.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep_ab")
    ap.add_argument("--other", type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("sweep_ab times CUDA kernels and needs a card")
    if args.child:
        _child()
        return
    if args.other is None:
        ap.error("--other is required")
    this = pathlib.Path(__file__).resolve().parents[3]
    print(f"card: {torch.cuda.get_device_name(0)}; grid {NY + 2}x{NX + 2}, "
          "5-point; ms a call, warm / cold")
    digests = {}
    for rnd in range(args.rounds):
        for label, tree in (("other", args.other), ("this", this),
                            ("this", this), ("other", args.other)):
            res = _run(tree.resolve())
            for key, row in res.items():
                extra = (f" main_digest={row['main_digest']} "
                         f"subnormal_cells={row['subnormal_cells']}"
                         if "main_digest" in row else "")
                print(f"round {rnd} {label:5s} {key:17s} "
                      f"warm_ms={row['warm_ms']:.6f} "
                      f"cold_ms={row['cold_ms']:.6f} "
                      f"digest={row['digest']}{extra}")
                if row["digest"] is not None:
                    digests.setdefault(key, set()).add(row["digest"])
    bad = sorted(k for k, d in digests.items() if len(d) != 1)
    if bad:
        sys.exit(f"sweep_ab: outputs differ between the checkouts: {bad}")
    print("sweep_ab: outputs equal bit for bit in both checkouts")


if __name__ == "__main__":
    main()
