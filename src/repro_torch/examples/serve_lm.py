"""Serve batched generation requests against a smoke model.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_lm")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="deepseek-7b")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch)
    model = build_model(cfg, device=args.device,
                        generator=torch.Generator(args.device).manual_seed(0))
    model.requires_grad_(False)

    rng = np.random.default_rng(0)
    requests = [Request(prompt=rng.integers(0, cfg.vocab_size, 12,
                                            dtype=np.int32),
                        max_new_tokens=16,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i in range(6)]

    engine = ServeEngine(model, batch_size=3, max_len=64, rng_seed=0)
    for i, r in enumerate(engine.generate(requests)):
        kind = "greedy" if r.temperature == 0 else f"T={r.temperature}"
        print(f"req{i} ({kind}): {r.generated}")


if __name__ == "__main__":
    main()
