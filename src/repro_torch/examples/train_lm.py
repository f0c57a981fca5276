"""Train a small LM end-to-end on the synthetic Markov corpus.

Uses the qwen2.5 smoke architecture (~a few M params); loss drops well
below the uniform baseline within ~60 steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer as O
from repro_torch.train.data import DataConfig, make_pipeline
from repro_torch.train.trainstep import init_state, make_train_step


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_lm")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config("qwen2.5-3b")
    model = build_model(cfg, device=args.device,
                        generator=torch.Generator(args.device).manual_seed(0))
    opt = O.adamw(O.warmup_cosine(3e-3, 10, 100))
    state = init_state(model, opt)
    step = make_train_step(model, opt)

    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                    global_batch=8))
    losses = []
    for batch in data.batches():
        if batch["step"] >= args.steps:
            break
        state, metrics = step(state, {
            k: torch.from_numpy(batch[k]).long().to(args.device)
            for k in ("tokens", "labels")})
        losses.append(float(metrics["ce"]))
        if batch["step"] % 10 == 0:
            print(f"step {batch['step']:3d}  ce={losses[-1]:.4f} "
                  f"(uniform={np.log(cfg.vocab_size):.2f}, "
                  f"optimal={np.log(4):.2f})")
    return losses


if __name__ == "__main__":
    main()
