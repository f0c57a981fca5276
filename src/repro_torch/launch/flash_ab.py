"""K8's tensor-core kernel against another checkout's, on one card.

    python -m repro_torch.launch.flash_ab --other PATH [--shape B,S,H,K,hd]
        [--non-causal] [--rounds 2]

Builds ``PATH/src/repro_torch/csrc/flash_attention_sm90.cu`` (another
checkout of this repository, such as a parent commit unpacked with ``git
archive``) beside this checkout's kernel, runs both on the same bf16
inputs (seeded on the card) at the shape, qwen2.5-3b's serving prefill by
default, and prints whether their outputs are equal bit for bit and each
kernel's device time (CUDA events, ``obs.timing.device_ms``) in turns:
this, other, other, this for each round. Exits non-zero without a card,
or if the outputs differ.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

LIB = "flash_attention_sm90"


def _runner(lib: ctypes.CDLL, q, k, v, causal: bool):
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = getattr(lib, f"repro_{LIB}")

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 sq, sk, h, kh, hd, int(causal), hd ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{LIB} launch failed: cudaError_t {err}")
        return out
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.flash_ab")
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--shape", default="4,2048,16,2,128",
                    help="B,S,H,K,hd (default: qwen2.5-3b's prefill)")
    ap.add_argument("--non-causal", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flash_ab compares CUDA kernels and needs a card")

    from repro_torch.kernels import build
    from repro_torch.obs.timing import device_ms
    b, s, h, kh, hd = (int(x) for x in args.shape.split(","))
    causal = not args.non_causal
    g = torch.Generator(device="cuda").manual_seed(s + h)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for shape in ((b, s, h, hd), (b, s, kh, hd),
                                      (b, s, kh, hd)))
    this = _runner(build.load(LIB), q, k, v, causal)
    other = _runner(build.load(LIB, args.other.resolve() / "src" /
                               "repro_torch" / "csrc"), q, k, v, causal)
    a, c = this().clone(), other().clone()
    torch.cuda.synchronize()
    same = torch.equal(a, c)
    print(f"shape B={b} S={s} H={h} K={kh} hd={hd} causal={causal}: outputs "
          f"{'equal bit for bit' if same else 'DIFFER'} (max |diff| "
          f"{float((a.float() - c.float()).abs().max()):.3e})")
    for r in range(args.rounds):
        times = [(name, device_ms(fn, reps=7, inner=10))
                 for name, fn in (("this", this), ("other", other),
                                  ("other", other), ("this", this))]
        print(f"round {r}: " + " ".join(f"{n}={t:.6f}ms" for n, t in times))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()
