"""Serving driver on the port: batched generation with the slot engine.

Runs on the card unless ``--device cpu`` is given; without a card it
fails. Weights are random, made from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --smoke --device cpu --requests 8 --prompt-len 16 --max-new 24

``--arch mamba2-2.7b`` serves the SSM family the same way, and ``--arch
zamba2-7b`` the hybrid (Mamba2 layers behind a shared attention block);
their prompt length must be a multiple of ``ssm_chunk`` (16 at smoke
size, 256 at full size) or shorter than it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model lives; cuda launches the kernels")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.core.stencil import require_device
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.family == "encoder":
        ap.error(f"{args.arch} is encoder-only: it has no decode step to "
                 f"serve")
    dev = require_device(args.device)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(args.seed))
    model.requires_grad_(False)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for _ in range(args.requests)]

    engine = ServeEngine(model, batch_size=args.batch,
                         max_len=args.prompt_len + args.max_new + 8,
                         rng_seed=args.seed)
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.generated) for r in done)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} device={where} requests={len(done)} "
          f"new_tokens={total_new} wall={dt:.2f}s "
          f"tok/s={total_new / dt:.1f}")
    for i, r in enumerate(done[:4]):
        print(f"  req{i}: prompt[:6]={r.prompt[:6].tolist()} "
              f"-> {r.generated[:10]}")


if __name__ == "__main__":
    main()
