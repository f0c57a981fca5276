"""Measured autotuner: pick the policy by timing it, then never again.

The port's copy of ``repro.engine.tune``. ``resolve_auto`` is a model;
this module is the measurement. For a ``(shape, dtype, spec, device)``
cell it times every registry policy whose plan validates on that device
model (one warm call, then a few timed ones, per sweep for fused
policies), picks the fastest, and persists the winner to a JSON cache.
The second request for the same cell is a dict lookup; across processes
it is a file read.

On a CUDA tensor the candidates' kernels are timed with CUDA events
(:func:`repro_torch.obs.timing.device_ms`); on a CPU tensor their plain
versions are timed with ``perf_counter``, as the reference times
interpret mode. Those CPU numbers are relative only and never stand for
a device's.

The cache maps ``key -> {"policy", "us_per_sweep", "skipped",
"device"}``. Keys fold in what changes the winner: grid shape, dtype, the
spec's taps and weights, the device model, the fusion depth, the bm
request, the torch device the timing ran on (``cuda`` or ``cpu``, in
place of the reference's ``interpret``), the mesh, masked and overlap.
The port keeps its own file (``$REPRO_TORCH_TUNE_CACHE``, else
``~/.cache/repro_torch/engine_tune.json``) and never reads the
reference's, so the two packages' winners never alias. Each cache file
is loaded and saved as its own unit.
"""
from __future__ import annotations

import json
import os
import statistics
import time

import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.engine.device import DeviceModel, get_device
from repro_torch.engine.dispatch import get_policy, registry
from repro_torch.engine.plan import DEFAULT_T, PlanError, dtype_name, plan_for
from repro_torch.engine.policies import copy_ring
from repro_torch.engine.schedule import effective_depth
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.timing import device_ms
from repro_torch.obs.trace import span as _obs_span

#: Default on-disk location; override per call or via
#: $REPRO_TORCH_TUNE_CACHE.
DEFAULT_CACHE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch", "engine_tune.json")
CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"

# One in-memory dict per cache file, loaded lazily; kept separate so
# saving one file never writes another file's entries into it.
_caches: dict[str, dict[str, dict]] = {}
_loaded_paths: set[str] = set()

#: Number of measurement passes taken since import (a cache hit must not
#: bump this).
measure_count = 0


def _cache_path(cache_path: str | None) -> str:
    return cache_path or os.environ.get(CACHE_ENV, DEFAULT_CACHE_PATH)


def tune_key(shape, dtype, spec: StencilSpec, device: DeviceModel, *,
             t: int | None, bm: int | None, torch_device: str = "cuda",
             mesh: tuple | None = None, masked: bool = False,
             overlap: bool = False) -> str:
    """Stable cache key for one autotune cell: the reference's key with
    ``torch_device=cuda|cpu`` in place of ``interpret=``."""
    return "|".join([
        "x".join(str(int(s)) for s in shape),
        dtype_name(dtype),
        f"taps={spec.offsets}w={spec.weights}",
        device.name,
        f"t={t if t is not None else DEFAULT_T}",
        f"bm={bm if bm is not None else 'auto'}",
        f"torch_device={torch.device(torch_device).type}",
        "mesh=" + ("local" if mesh is None else
                   "x".join(str(int(m)) for m in mesh)),
        f"masked={bool(masked)}",
        f"overlap={bool(overlap)}",
    ])


def _cache_for(path: str) -> dict[str, dict]:
    """This file's in-memory view, seeded from disk once per path."""
    cache = _caches.setdefault(path, {})
    if path not in _loaded_paths:
        _loaded_paths.add(path)
        try:
            with open(path) as f:
                on_disk = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            on_disk = {}
        for k, v in on_disk.items():
            cache.setdefault(k, v)
    return cache


def _save(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_caches.get(path, {}), f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def clear(*, memory_only: bool = True) -> None:
    """Drop the in-memory caches (tests); on-disk files are left alone
    unless ``memory_only`` is False."""
    _caches.clear()
    _loaded_paths.clear()
    if not memory_only:
        path = _cache_path(None)
        if os.path.exists(path):
            os.remove(path)


def _time_policy(u: torch.Tensor, spec: StencilSpec, name: str, *, bm, t,
                 device: DeviceModel, reps: int = 3) -> float:
    """Median seconds per *sweep* of one policy call on ``u``."""
    p = get_policy(name)
    kw = {"t": t} if p.fused else {}
    sweeps = t if p.fused else 1
    if u.device.type == "cuda":
        out = torch.empty_like(u)
        copy_ring(u, out, spec.radius)
        ms = device_ms(lambda: p.fn(u, spec, bm=bm, device=device, out=out,
                                    **kw), reps=reps)
        return ms / 1e3 / sweeps
    p.fn(u, spec, bm=bm, device=device, **kw)  # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        p.fn(u, spec, bm=bm, device=device, **kw)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) / sweeps


def measure(shape, dtype, spec: StencilSpec, *, t: int | None = None,
            bm: int | None = None, torch_device: str = "cuda",
            device: str | DeviceModel | None = None,
            masked: bool = False) -> dict:
    """Time every policy that plans on ``device``; return the record.

    Candidates whose plan fails validation are skipped (listed by name in
    ``skipped``). Fused candidates run at depth ``t`` and are charged per
    sweep; with ``masked`` they are gated by the masked plan's footprint.
    The grid is zeros of ``shape`` and ``dtype`` on ``torch_device``.
    """
    global measure_count
    measure_count += 1
    dev = get_device(device)
    t_eff = t if t is not None else DEFAULT_T
    u = torch.zeros(tuple(int(s) for s in shape),
                    dtype=getattr(torch, dtype_name(dtype)),
                    device=torch_device)
    timings: dict[str, float] = {}
    skipped: dict[str, str] = {}
    for p in registry():
        kw_t = t_eff if p.fused else None
        try:
            plan_for(shape, dtype, spec, p.name, bm=bm, t=kw_t, device=dev,
                     masked=masked and p.fused)
        except PlanError as e:
            skipped[p.name] = str(e)
            continue
        with _obs_span("tune.measure", policy=p.name, device=dev.name,
                       shape=tuple(int(s) for s in shape)) as sp:
            timings[p.name] = _time_policy(u, spec, p.name, bm=bm, t=kw_t,
                                           device=dev)
            sp.set(us_per_sweep=round(timings[p.name] * 1e6, 3))
    if not timings:
        raise PlanError(
            f"no policy plans for grid {tuple(shape)} ({dtype_name(dtype)},"
            f" {spec.taps} taps) on {dev.name}: "
            + "; ".join(f"{k}: {v}" for k, v in skipped.items()))
    best = min(timings, key=timings.get)
    return {
        "policy": best,
        "us_per_sweep": {k: round(v * 1e6, 3) for k, v in timings.items()},
        "skipped": sorted(skipped),
        "device": dev.name,
    }


def best_policy(shape, dtype, spec: StencilSpec, *, iters: int = 1,
                t: int | None = None, bm: int | None = None,
                torch_device: str = "cuda",
                device: str | DeviceModel | None = None,
                mesh: tuple | None = None, masked: bool = False,
                overlap: bool = False,
                cache_path: str | None = None) -> str:
    """The measured-fastest policy for this cell; measured at most once.

    Lookup order: in-memory cache, then the JSON file, then a measurement
    (persisted). A single-sweep call re-buckets to ``t=1``
    (``effective_depth``), as ``run``'s remainder does, rather than
    inheriting a t=8 winner it cannot run.
    """
    dev = get_device(device)
    t_eff = effective_depth(iters, t)
    key = tune_key(shape, dtype, spec, dev, t=t_eff, bm=bm,
                   torch_device=torch_device, mesh=mesh, masked=masked,
                   overlap=overlap)
    path = _cache_path(cache_path)
    cache = _cache_for(path)
    rec = cache.get(key)
    if rec is None:
        _metrics.counter("engine.tune.miss").inc()
        rec = measure(shape, dtype, spec, t=t_eff, bm=bm,
                      torch_device=torch_device, device=dev, masked=masked)
        cache[key] = rec
        _save(path)
    else:
        _metrics.counter("engine.tune.hit").inc()
    return rec["policy"]


def warm(shapes, dtype, spec: StencilSpec, *, iters: int = 1,
         t: int | None = None, bm: int | None = None,
         torch_device: str = "cuda",
         device: str | DeviceModel | None = None,
         mesh: tuple | None = None, masked: bool = False,
         overlap: bool = False,
         cache_path: str | None = None) -> dict[tuple, str]:
    """Populate the tune cache for a batch of ringed grid shapes before
    traffic arrives; returns ``{shape: winner}``. Idempotent: a cell
    already cached (in memory or on disk) is never measured again, so
    ``measure_count`` does not move for it."""
    out: dict[tuple, str] = {}
    for shape in shapes:
        key = tuple(int(s) for s in shape)
        out[key] = best_policy(key, dtype, spec, iters=iters, t=t, bm=bm,
                               torch_device=torch_device, device=device,
                               mesh=mesh, masked=masked, overlap=overlap,
                               cache_path=cache_path)
    return out


def cache_info() -> dict:
    """Entries resident in memory and measurements taken."""
    return {"entries": sum(len(c) for c in _caches.values()),
            "measure_count": measure_count}

