"""Checkpointing: atomic, resumable, optionally asynchronous (twin of
``repro.train.checkpoint``).

Layout, the reference's: ``<dir>/step_<N>/arrays.npz`` (``leaf_<i>``, the
tree's leaves in order) + ``meta.json``, written to a ``.tmp`` sibling
and atomically renamed, so a crash mid-write never corrupts the latest
checkpoint. The tree's order is the reference's: dict keys sorted,
NamedTuple fields in order, ``None`` holds no leaf. A bf16 leaf is
stored as raw 2-byte records, as ``ml_dtypes`` arrays are.
``AsyncCheckpointer.save_async`` copies the device tensors to the host
first and writes on a background thread, so the train loop never waits
on the disk. ``latest_step``/``restore`` implement ``--resume auto``;
``restore`` writes a checkpoint into the tensors of ``like`` in place
(the train state is the model's own parameters), after checking every
leaf's shape, and raises on any mismatch before it writes.
:func:`state_digest` fingerprints a tree's bits on its device, so two
runs can be compared without copying their states to the host.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

_BF16_RECORD = np.dtype("V2")


def _flatten(tree) -> tuple[list, Any]:
    """(leaves, a skeleton that :func:`_unflatten` fills again)."""
    leaves: list = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(node)
        return len(leaves) - 1

    return leaves, walk(tree)


def _unflatten(skeleton, leaves: list):
    def fill(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(fill(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return leaves[node]

    return fill(skeleton)


def _to_numpy(leaf, copy: bool = False) -> np.ndarray:
    """``leaf`` as numpy; ``copy`` makes it a snapshot that later writes
    to ``leaf`` (a CPU tensor's storage is shared otherwise) leave alone."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RECORD)
        return t.numpy()
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _host(tree):
    leaves, skeleton = _flatten(tree)
    return _unflatten(skeleton, [_to_numpy(leaf, copy=True)
                                 for leaf in leaves])


def save(ckpt_dir: str, step: int, tree: Any, meta: dict | None = None,
         keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, _ = _flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves),
                   **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Snapshot-on-call, write-on-thread. One outstanding write at a time
    (a second save waits for the first: bounded memory)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save_async(self, step: int, tree: Any, meta: dict | None = None):
        self.wait()
        # Device -> host snapshot happens NOW (training then writes the
        # state in place).
        snapshot = _host(tree)

        def work():
            try:
                save(self.ckpt_dir, step, snapshot, meta, self.keep)
            except Exception as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, like) -> Any:
    if not isinstance(like, torch.Tensor):
        return arr
    if like.dtype == torch.bfloat16 and arr.dtype.kind == "V" \
            and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: its tensors are overwritten
    in place (in their own dtype and device) and returned in ``like``'s
    structure; its other leaves come back as numpy arrays."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves, skeleton = _flatten(like)
        if len(leaves) != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, expected "
                f"{len(leaves)} — model/optimizer structure changed?")
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for i, (arr, l) in enumerate(zip(arrays, leaves)):
        if hasattr(l, "shape") and tuple(arr.shape) != tuple(l.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(l.shape)}")
    out = []
    with torch.no_grad():
        for arr, l in zip(arrays, leaves):
            val = _from_numpy(arr, l)
            if isinstance(l, torch.Tensor):
                l.copy_(val)
                val = l
            out.append(val)
    return _unflatten(skeleton, out)


def state_digest(tree) -> str:
    """A digest of every leaf's bits, computed on its device: equal
    digests mean equal states (up to a hash collision)."""
    leaves, _ = _flatten(tree)
    total = 0
    for i, leaf in enumerate(leaves):
        t = torch.as_tensor(leaf).detach().contiguous().reshape(-1)
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.int8}[t.element_size()]
        v = t.view(bits).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        total = (total * 1_000_003 + int((v * w).sum()) + i) % (1 << 61)
    return f"{total:016x}"


def read_meta(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")
    with open(path) as f:
        return json.load(f)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
