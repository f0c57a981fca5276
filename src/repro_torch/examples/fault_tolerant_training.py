"""Fault tolerance demo: a train step that crashes mid-run, a checkpoint
restore that carries on, and straggler detection flagging a slow step.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_training \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer as O
from repro_torch.train.data import DataConfig, make_pipeline
from repro_torch.train.fault import FaultConfig, FaultTolerantRunner
from repro_torch.train.trainstep import init_state, make_train_step


def main(argv=None) -> FaultTolerantRunner:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "fault_tolerant_training")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_fault_demo"))
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = configs.get_smoke_config("deepseek-7b")
    model = build_model(cfg, device=args.device,
                        generator=torch.Generator(args.device).manual_seed(0))
    opt = O.adamw(1e-3)
    state = init_state(model, opt)
    inner = make_train_step(model, opt)

    crashes = {"left": 2}

    def flaky_step(state, batch):
        if batch.pop("_crash", False) and crashes["left"]:
            crashes["left"] -= 1
            raise RuntimeError("injected device failure")
        if batch.pop("_slow", False):
            time.sleep(2.5)  # injected straggler, >> any step-time noise
        return inner(state, batch)

    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=4))

    def batches():
        for b in data.batches():
            yield {"tokens": torch.from_numpy(b["tokens"]).long().to(
                       args.device),
                   "labels": torch.from_numpy(b["labels"]).long().to(
                       args.device),
                   "_crash": b["step"] == 12,
                   "_slow": b["step"] == 18}

    stragglers = []
    runner = FaultTolerantRunner(
        flaky_step, state,
        FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=5,
                    min_steps_before_flag=5, straggler_zscore=3.0),
        on_straggler=lambda s: stragglers.append(s))
    runner.run(batches(), 25,
               metrics_cb=lambda s, m, dt: print(
                   f"step {s:2d} ce={float(m['ce']):.3f} {dt * 1e3:6.0f} ms"))
    print(f"\nrecovered from {runner.restores} injected failure(s); "
          f"straggler steps flagged: {stragglers}")
    if not (runner.restores >= 1 and stragglers):
        raise SystemExit("demo expectations not met")
    print("fault-tolerance demo OK")
    return runner


if __name__ == "__main__":
    main()
