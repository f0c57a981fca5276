"""Training launcher on the port: any --arch, fault-tolerant (twin of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir "$TMPDIR/ck" --resume auto

Runs on the card unless ``--device cpu`` is given; without a card it
fails. Weights are random, made from ``--seed``; the data is the
synthetic Markov corpus (``train.data``). It feeds tokens and labels, as
the reference's launcher does, so it trains the decoders (dense, MoE,
MLA, VLM backbone, SSM, hybrid) and not the encoder. Each step prints its
CE and milliseconds; the end prints the first and last CE, the card's
peak memory and a digest of the final state (equal digests: equal
states, bit for bit).

Beyond the reference's flags: ``--device``; ``--layers N`` cuts the
model's depth to N layers at full width; ``--deterministic`` turns on
``torch.use_deterministic_algorithms`` (the embedding's backward
otherwise sums with atomics on the card, so two runs may differ in the
last bits).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "lion", "sgd"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt in the temp directory")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model lives")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.core.stencil import require_device
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer as O
    from repro_torch.train.data import DataConfig, make_pipeline
    from repro_torch.train.checkpoint import state_digest
    from repro_torch.train.fault import FaultConfig, FaultTolerantRunner
    from repro_torch.train.trainstep import init_state, make_train_step

    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.family == "encoder":
        ap.error(f"{args.arch} is encoder-only: this launcher feeds tokens "
                 f"(as the reference's does)")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = require_device(args.device)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(args.seed))
    sched = O.warmup_cosine(args.lr, args.steps // 10 + 1, args.steps)
    opt = {"adamw": O.adamw, "lion": O.lion,
           "sgd": O.sgd}[args.optimizer](sched)
    state = init_state(model, opt)
    n = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n / 1e6:.1f}M "
          f"device={dev}")

    step_fn = make_train_step(model, opt, args.accum)
    data = make_pipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))
    ckpt_dir = args.ckpt_dir or FaultConfig().ckpt_dir
    runner = FaultTolerantRunner(step_fn, state, FaultConfig(
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every))
    start = runner.resume_or_init() if args.resume == "auto" else 0
    if start:
        print(f"resumed from step {start - 1}")

    losses = []

    def on_metrics(step, metrics, dt):
        ce = float(metrics["ce"])
        losses.append(ce)
        print(f"step {step:5d}  ce={ce:.4f}  {dt * 1e3:7.1f} ms/step",
              flush=True)

    def batches():
        for b in data.batches(start_step=start):
            yield {"tokens": torch.from_numpy(b["tokens"]).long().to(dev),
                   "labels": torch.from_numpy(b["labels"]).long().to(dev)}

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    state = runner.run(batches(), args.steps, start_step=start,
                       metrics_cb=on_metrics)
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured (cpu)")
    print(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s; "
          f"first ce={losses[0]:.4f} last ce={losses[-1]:.4f}; peak memory "
          f"{peak}")
    print(f"state digest={state_digest(state)}")


if __name__ == "__main__":
    main()
