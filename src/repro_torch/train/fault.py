"""Fault tolerance: checkpoint/restart, straggler detection and elastic
re-mesh (twin of ``repro.train.fault``).

The failure model: (a) a step raises (device error, preemption signal),
(b) a host silently slows down (straggler), (c) a slice disappears and
the job must continue on fewer devices. ``FaultTolerantRunner`` handles
(a) and (b) around an arbitrary step function: periodic async
checkpoints; restore-and-retry on step failure (bounded retries); EWMA
step-time z-score straggler flagging with a mitigation callback;
:func:`remesh_state` re-lays a train state out onto another mesh (c). Where
the reference calls ``block_until_ready`` on the step's first metric,
the runner synchronizes that metric's device, so a step's time is its
device time too. Before it restores after a failure, the runner waits
for a checkpoint still being written, so the retry starts from the
newest complete one (the reference reads whatever is on disk at that
moment).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 3
    straggler_window: int = 20      # steps in the EWMA
    straggler_zscore: float = 3.0   # flag threshold
    min_steps_before_flag: int = 10


class StragglerDetector:
    """EWMA + variance of step wall-times; flags outlier steps."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.mean = None
        self.var = 0.0
        self.n = 0
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        a = 2.0 / (self.cfg.straggler_window + 1)
        if self.n == 0:
            # The first step carries one-time costs (kernel builds, cast
            # caches); don't fold it into the baseline.
            self.n = 1
            return False
        if self.mean is None:
            self.mean, self.var = dt, 0.0
        flagged = False
        std = max(np.sqrt(self.var), 1e-6)
        if (self.n >= self.cfg.min_steps_before_flag
                and dt > self.mean + self.cfg.straggler_zscore * std):
            flagged = True
            self.events.append((step, dt, self.mean))
        else:
            # only fold non-outlier samples into the stats
            d = dt - self.mean
            self.mean += a * d
            self.var = (1 - a) * (self.var + a * d * d)
        self.n += 1
        return flagged


def _synchronize(metrics) -> None:
    """Wait for the device work behind the step's first metric."""
    first = next(iter(metrics.values()), None) if isinstance(
        metrics, dict) else metrics
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.current_stream(first.device).synchronize()


class FaultTolerantRunner:
    def __init__(self, step_fn: Callable, state: Any, fault_cfg: FaultConfig,
                 on_straggler: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.state = state
        self.cfg = fault_cfg
        self.ckptr = ckpt.AsyncCheckpointer(fault_cfg.ckpt_dir,
                                            keep=fault_cfg.keep)
        self.detector = StragglerDetector(fault_cfg)
        self.on_straggler = on_straggler
        self.restores = 0
        self.last_good_step = -1

    def resume_or_init(self) -> int:
        """Restore the latest checkpoint if one exists; returns start step."""
        latest = ckpt.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return 0
        self.state = ckpt.restore(self.cfg.ckpt_dir, latest, self.state)
        self.last_good_step = latest
        return latest + 1

    def run(self, batches, n_steps: int, start_step: int = 0,
            metrics_cb: Optional[Callable] = None):
        step = start_step
        it = iter(batches)
        while step < n_steps:
            batch = next(it)
            retries = 0
            while True:
                t0 = time.perf_counter()
                try:
                    self.state, metrics = self.step_fn(self.state, batch)
                    _synchronize(metrics)
                    break
                except Exception:
                    retries += 1
                    self.restores += 1
                    if retries > self.cfg.max_retries:
                        self.ckptr.wait()
                        raise
                    self.ckptr.wait()
                    latest = ckpt.latest_step(self.cfg.ckpt_dir)
                    if latest is not None:
                        self.state = ckpt.restore(self.cfg.ckpt_dir, latest,
                                                  self.state)
            dt = time.perf_counter() - t0
            if self.detector.observe(step, dt) and self.on_straggler:
                self.on_straggler(step)
            if metrics_cb:
                metrics_cb(step, metrics, dt)
            if step % self.cfg.ckpt_every == 0 and step > 0:
                self.ckptr.save_async(step, self.state)
                self.last_good_step = step
            step += 1
        self.ckptr.wait()
        return self.state


def remesh_state(state: Any, new_mesh, specs, rules=None) -> Any:
    """Re-lay a train state out onto ``new_mesh`` (elastic re-scale).

    Works for scale-down (lost shards) and scale-up: every leaf laid out
    on a mesh (a ``dist.sharding.Sharded``) is first put back together,
    then the specs are rebuilt from the parameters' logical axes
    (``specs``, as ``model.logical_axes()`` gives them) by
    ``state_shardings`` against the new mesh, and each tensor leaf is laid
    out by its spec, its blocks copied to the new shards' devices. Leaves
    that are not tensors stay as they are. The reference moves each leaf
    through the host (``device_get``, ``device_put``); the port copies
    device to device.

    Between process meshes (:class:`~repro_torch.dist.process.
    ProcessMesh`), every rank of the old mesh calls it: each leaf is
    all-gathered on the old mesh and each rank keeps its block of the new
    one. The new mesh may span fewer ranks
    (an elastic scale-down onto a subgroup); a rank outside it holds no
    blocks.
    """
    from repro_torch.dist.sharding import (Sharded, _map, lay_out,
                                           state_shardings)
    whole = _map(lambda x, _: x.full() if isinstance(x, Sharded) else x,
                 state)
    sh = state_shardings(whole, specs, new_mesh, rules)
    return _map(lambda x, s: lay_out(x, s, new_mesh)
                if isinstance(x, torch.Tensor) else x, whole, sh)
