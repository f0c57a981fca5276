"""K8 against another checkout's K8, on one card.

    python -m repro_torch.launch.flash_ab --other PATH [--dtype bfloat16]
        [--shape B,S,H,K,hd] [--non-causal] [--rounds 2]

Builds the other checkout's source of the route ``--dtype`` picks
(``PATH/src/repro_torch/csrc/flash_attention_sm90.cu`` for bfloat16,
``flash_attention.cu`` for float32; another checkout of this repository,
such as a parent commit unpacked with ``git archive``) beside this
checkout's, runs both on the same inputs (seeded on the card) at the
shape, qwen2.5-3b's serving prefill by default, and prints how their
outputs compare and each kernel's device time (CUDA events,
``obs.timing.device_ms``) in turns: this, other, other, this for each
round. bf16 outputs must be equal bit for bit (the A/B of a change that
keeps the bf16 kernel's arithmetic); f32 outputs within rtol = atol =
2e-5 of each other, the f32 gate, as the two may round differently.
Exits non-zero without a card, or if the outputs differ beyond that.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

LIBS = {"bfloat16": "flash_attention_sm90", "float32": "flash_attention"}
F32_TOL = 2e-5


def _runner(lib: ctypes.CDLL, name: str, q, k, v, causal: bool):
    from repro_torch.kernels.build import on_card
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = getattr(lib, f"repro_{name}")

    def run():
        with on_card(q, k, v, out) as stream:
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, sq, sk, h, kh, hd, int(causal),
                     hd ** -0.5, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
        return out
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.flash_ab")
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--dtype", choices=sorted(LIBS), default="bfloat16")
    ap.add_argument("--shape", default="4,2048,16,2,128",
                    help="B,S,H,K,hd (default: qwen2.5-3b's prefill)")
    ap.add_argument("--non-causal", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flash_ab compares CUDA kernels and needs a card")

    from repro_torch.kernels import build
    from repro_torch.obs.timing import device_ms
    name = LIBS[args.dtype]
    b, s, h, kh, hd = (int(x) for x in args.shape.split(","))
    causal = not args.non_causal
    g = torch.Generator(device="cuda").manual_seed(s + h)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(
        getattr(torch, args.dtype)) for shape in ((b, s, h, hd),
                                                  (b, s, kh, hd),
                                                  (b, s, kh, hd)))
    this = _runner(build.load(name), name, q, k, v, causal)
    other = _runner(build.load(name, args.other.resolve() / "src" /
                               "repro_torch" / "csrc"), name, q, k, v, causal)
    a, c = this().clone(), other().clone()
    torch.cuda.synchronize()
    diff = (a.float() - c.float()).abs()
    if args.dtype == "bfloat16":
        same = torch.equal(a, c)
        verdict = "equal bit for bit" if same else "DIFFER"
    else:
        excess = float((diff - F32_TOL * c.float().abs()).max())
        same = excess <= F32_TOL
        verdict = (f"{'within' if same else 'NOT within'} rtol=atol="
                   f"{F32_TOL:g} (largest excess over rtol*|other| "
                   f"{excess:.3e})")
    print(f"{args.dtype} shape B={b} S={s} H={h} K={kh} hd={hd} "
          f"causal={causal}: outputs {verdict} (max |diff| "
          f"{float(diff.max()):.3e})")
    for r in range(args.rounds):
        times = [(who, device_ms(fn, reps=7, inner=10))
                 for who, fn in (("this", this), ("other", other),
                                 ("other", other), ("this", this))]
        print(f"round {r}: " + " ".join(f"{n}={t:.6f}ms" for n, t in times))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()
