"""Stencil solves as a service: bucketed continuous batching with
residual-based eviction.

The port's copy of ``repro.serve.solve``. :class:`SolveServer` is the
request-level scheduling layer above the engine:

* **admission**: each :class:`SolveRequest` is validated by building its
  real :class:`~repro_torch.engine.schedule.SweepSchedule` (policy
  resolution, depth clamping), planning its block's kernel on the device
  model (its budget, and the compiled K1's tile row, which a deep ``t``
  leaves no room in) and running
  :func:`repro_torch.analysis.check_schedule`; rejections are structured
  ``SCHED-*`` diagnostics with the reference's text.
* **bucketing**: compatible requests (same ringed shape, spec, dtype,
  resolved policy, block depth ``t``, device model and torch device)
  share a :class:`BucketKey`; :func:`repro_torch.analysis.check_bucket`
  gates every slot assignment.
* **superblock**: each bucket advances all its slots up to
  ``superblock`` blocks of ``t`` sweeps in a host loop that never waits
  on the device. A block is one :func:`~repro_torch.engine.run_batched`
  call (one batched K1 launch for the temporal policy, the slots a grid
  axis of the kernel), the per-slot residuals on the device (on the card
  one batched K2 sweep, a difference and a reduction), and ``torch.where``
  freezing every converged, spent or empty slot at its stopping block.
  The ``(k, S)`` residual and liveness history and the flags come back
  by a non-blocking copy into pinned host memory behind a CUDA event, so
  the readback overlaps the next bucket's launches; the replay waits on
  that event, the one host sync of a superblock.
* **lone bypass**: a bucket whose only traffic is one request (no queue,
  no stream) runs it through :func:`~repro_torch.engine.run_converged`.
* **eviction**: a slot whose residual reaches its request's ``tol`` (or
  whose budget is spent) is evicted and refilled from the bucket's queue
  before the next superblock. Realized iteration counts are multiples of
  ``t``, and every result equals ``engine.run(iters=request.iters_done)``
  bit for bit.
* **result copies**: an evicted lane is copied into a free buffer of its
  bucket's staging pool (pinned host memory on the card, at most
  ``max_slots`` lanes a bucket, reused for the server's life) without
  stopping the stream, behind an event. The slot is free at once; stream
  order keeps the copy ahead of the refill. The server's copy thread
  waits on the event and copies the buffer into a CPU tensor of the
  request's own (fresh host memory, whose first touch costs more than
  the copy), while the main thread goes on launching; a step ends by
  finishing the copies that have landed, and only then is a request
  done.
* **streaming** and **warmup** as in the reference.

The server keeps its tensors on ``torch_device``, ``"cuda"`` unless the
caller asks for the CPU (where the kernels' plain versions run); with no
card it raises. ``device`` is the device model the plans are validated
against, as in the reference.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.analysis import check_bucket, check_schedule
from repro_torch.analysis.diagnostics import Report, error
from repro_torch.core.stencil import (StencilSpec, ftz, interior,
                                      jacobi_2d_5pt, require_device,
                                      residual)
from repro_torch.engine.device import DeviceModel, get_device
from repro_torch.engine.dispatch import get_policy, run_batched, run_converged
from repro_torch.engine.plan import PlanError, dtype_name, plan_for
from repro_torch.engine.policies import stencil_rowchunk
from repro_torch.engine.schedule import build_schedule, effective_depth
from repro_torch.interop import grid_from_numpy
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import (begin as _obs_begin, get_tracer,
                                   span as _obs_span, use_tracer)


class SolveRejected(ValueError):
    """A request the server cannot admit; the message is the structured
    diagnostic report (stable ``SCHED-*`` codes)."""


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """The static launch identity a batch must agree on.

    The reference's key with the torch device type (``"cuda"`` or
    ``"cpu"``) in place of ``interpret``. ``dtype`` is a name
    (``"float32"``, ``"bfloat16"``); :meth:`describe` is the reference's
    text, so trace attrs of the two servers compare equal.
    """

    shape: tuple[int, int]
    dtype: str
    spec: StencilSpec
    policy: str
    t: int
    device: "str | DeviceModel | None"
    torch_device: str

    def fields(self) -> dict:
        """Field dict for :func:`repro_torch.analysis.check_bucket`."""
        return {"shape": self.shape, "dtype": self.dtype,
                "spec": self.spec, "policy": self.policy, "t": self.t,
                "device": self.device, "torch_device": self.torch_device}

    def describe(self) -> str:
        return (f"{self.shape[0]}x{self.shape[1]} {self.dtype} "
                f"{self.policy} t={self.t} "
                f"dev={getattr(self.device, 'name', self.device)}")


@dataclasses.dataclass(frozen=True)
class SolveProgress:
    """One streamed observation: the state after a block of ``t`` sweeps."""

    iters_done: int
    residual: float
    iterate: Optional[torch.Tensor] = None  # host copy; stream_iterates


@dataclasses.dataclass
class SolveRequest:
    """One solve: a ringed grid advanced until ``tol`` or ``max_iters``.

    ``tol=None`` disables residual eviction (fixed-iteration semantics).
    The realized iteration count is a multiple of the bucket cadence
    ``t`` and never exceeds ``max_iters``: the first multiple of ``t`` at
    which ``residual <= tol`` held, or ``(max_iters // t) * t``.
    ``stream`` is called with a :class:`SolveProgress` after every block;
    ``stream_iterates`` adds a host copy of the iterate. ``grid`` is a
    tensor or a numpy array (bf16 as ``ml_dtypes``); ``result`` is a host
    copy (a CPU tensor of the grid's dtype).
    """

    grid: "np.ndarray | torch.Tensor"
    spec: StencilSpec = dataclasses.field(default_factory=jacobi_2d_5pt)
    tol: float | None = None
    max_iters: int = 200
    policy: str = "auto"
    t: int | None = None
    stream: Callable[["SolveRequest", SolveProgress], None] | None = None
    stream_iterates: bool = False

    # Filled in by the server.
    id: int | None = None         # sequential, from admission
    result: torch.Tensor | None = None
    iters_done: int = 0
    residual: float | None = None
    converged: bool = False
    done: bool = False
    key: BucketKey | None = None
    target_blocks: int = 0
    blocks_done: int = 0
    submitted_s: float | None = None
    finished_s: float | None = None

    @property
    def latency_s(self) -> float | None:
        if self.submitted_s is None or self.finished_s is None:
            return None
        return self.finished_s - self.submitted_s


class _Bucket:
    """One batch lane-set: slots, queue, the ``(S, H, W)`` slot tensor
    ``us`` and per-bucket counters."""

    def __init__(self, key: BucketKey, max_slots: int):
        self.key = key
        self.max_slots = max_slots
        self.queue: collections.deque[SolveRequest] = collections.deque()
        self.slots: list[SolveRequest | None] = []
        self.us: torch.Tensor | None = None
        #: The staging pool's free buffers; ``staging`` counts those made.
        self.free: list[torch.Tensor] = []
        self.staging = 0
        self.launches = 0
        self.evicted_early = 0
        self.completed = 0
        self.peak_active = 0

    def admit(self, req: SolveRequest, fields: dict) -> None:
        """Gate a request into this bucket (stable ``SCHED-BUCKET-MIX``
        diagnostics on any static-field mismatch), then enqueue it."""
        report = check_bucket(self.key.fields(), fields)
        for d in report.errors:
            _metrics.counter(f"serve.rejected.{d.code}").inc()
        report.raise_if_errors(SolveRejected)
        self.queue.append(req)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def spent(self) -> bool:
        """No staging buffer is free, and no more may be made."""
        return not self.free and self.staging >= self.max_slots

    @property
    def busy(self) -> bool:
        return bool(self.queue) or self.active > 0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _tol_f32(tol: float) -> np.float32:
    """The largest float32 <= ``tol``: makes the on-device f32 comparison
    ``residual <= tol32`` decide exactly like the host-side double
    comparison ``float(residual) <= tol`` for every f32 residual."""
    t32 = np.float32(tol)
    if float(t32) > tol:
        t32 = np.nextafter(t32, np.float32(-np.inf))
    return t32


@dataclasses.dataclass(eq=False)
class _Copy:
    """A finished request's result on its way to the host: its lane
    staged in ``buf`` of its bucket's pool, and ``job``, the copy thread's
    :func:`_landed` of it. ``span`` is its ``serve.result_copy``, begun
    with the copy. Copies compare by identity."""

    bucket: _Bucket
    req: SolveRequest
    converged: bool
    buf: torch.Tensor
    job: concurrent.futures.Future
    span: object


def _to_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev`` without waiting for the device: through
    pinned memory and a non-blocking copy on CUDA."""
    if dev.type != "cuda":
        return x
    return x.pin_memory().to(dev, non_blocking=True)


def _host(u: torch.Tensor) -> torch.Tensor:
    """A CPU copy of the host tensor ``u`` that later writes to ``u``
    cannot reach, neither pinned nor a pool buffer: the staged route's
    last step (on the CPU, ``.cpu()`` would return ``u`` itself)."""
    return u.to("cpu", copy=True)


def _landed(buf: torch.Tensor, ev) -> torch.Tensor:
    """The staged copy in ``buf`` once its event has passed, as a tensor
    of its own (:func:`_host`)."""
    if ev is not None:
        ev.synchronize()
    return _host(buf)


def _host_buffer(x: torch.Tensor) -> torch.Tensor:
    """An empty host tensor like ``x``: pinned when ``x`` is on the card."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)


def _copy_out(xs, host):
    """Copy each of ``xs`` into its buffer of ``host``; returns the event
    to wait on before reading them. On CUDA the copies into pinned
    memory do not block the host; on the CPU they are done (no event)."""
    for h, x in zip(host, xs):
        h.copy_(x, non_blocking=True)
    if not xs[0].is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _readback(xs, dev: torch.device):
    """Start copying ``xs`` to the host; returns (host tensors, event).

    On CUDA the copies land in fresh pinned memory (:func:`_copy_out`);
    on the CPU the tensors are their own host copies."""
    if dev.type != "cuda":
        return list(xs), None
    host = [_host_buffer(x) for x in xs]
    return host, _copy_out(xs, host)


def _residuals(vs: torch.Tensor, key: BucketKey,
               spare: torch.Tensor | None) -> torch.Tensor:
    """Each lane's ``|apply(vs) - vs|_inf`` over the interior, bit for bit
    :func:`~repro_torch.core.stencil.residual`. On the card (but for the
    ``reference`` policy) the sweep is one batched K2 launch into
    ``spare``, which is bit for bit ``apply_stencil``; the difference is
    taken over the whole grids, contiguous (in place for f32; the ring,
    which K2 does not write, is never read), and its largest magnitude
    over the interior in one reduction. Subnormals flush as in
    ``residual``: K2's interior is flushed already, ``vs`` is flushed
    before the subtraction, and the difference's flush rides on the
    reduced value."""
    if spare is None:
        return residual(vs, key.spec)
    a = stencil_rowchunk(vs, key.spec, device=key.device, out=spare)
    if vs.dtype == torch.float32:
        d = a.sub_(ftz(vs))
    else:
        d = a.to(torch.float32).sub_(ftz(vs.to(torch.float32)))
    return ftz(torch.linalg.vector_norm(interior(d, key.spec.radius),
                                        ord=float("inf"), dim=(-2, -1)))


def _superblock(bucket: _Bucket, k: int, conv: torch.Tensor,
                n: torch.Tensor, tols: torch.Tensor, budgets: torch.Tensor):
    """Advance every slot up to ``k`` blocks of ``t`` sweeps, freezing each
    lane at its stopping block; returns ``(conv, hist_res, hist_live)``.

    The host loop queues launches only: no flag is read back inside it.
    A block runs the batch through one :func:`run_batched` call (which
    leaves ``us`` intact), takes each lane's residual on the device, and
    keeps the old iterate of every frozen lane (converged, spent or
    empty): ``torch.where`` writes the block's state into the kernel's
    output, which becomes the slot tensor. ``tols`` is ``-1.0`` for
    fixed-iteration lanes (residuals are >= 0, so it never fires).
    """
    key = bucket.key
    us = bucket.us
    spare = (torch.empty_like(us)
             if us.is_cuda and key.policy != "reference" else None)
    hist_res = torch.empty((k, us.shape[0]), dtype=torch.float32,
                           device=us.device)
    hist_live = torch.empty((k, us.shape[0]), dtype=torch.bool,
                            device=us.device)
    for j in range(k):
        live = (~conv) & (n < budgets)
        vs = run_batched(us, key.spec, policy=key.policy, iters=key.t,
                         t=key.t, device=key.device)
        res = _residuals(vs, key, spare)
        torch.where(live[:, None, None], vs, us, out=vs)
        n = n + live.to(n.dtype)
        conv = conv | (live & (res <= tols))
        hist_res[j] = res
        hist_live[j] = live
        us = vs
    bucket.us = us
    return conv, hist_res, hist_live


class SolveServer:
    """Admit, bucket, batch, evict: continuous batching for solves.

    ``max_slots`` caps each bucket's batch width (slot tensors grow and
    shrink in powers of two up to it). ``superblock`` caps how many blocks
    of ``t`` sweeps one step may advance a bucket before the host reads
    its flags back; convergence is still decided at every block boundary,
    so results do not depend on it. Requests submitted between steps are
    admitted at the next superblock boundary. ``device`` (the device
    model) and ``torch_device`` are server-wide.
    """

    def __init__(self, *, max_slots: int = 8, superblock: int = 4,
                 device: "str | DeviceModel | None" = None,
                 torch_device="cuda", tracer=None):
        if max_slots < 1:
            raise ValueError(f"max_slots={max_slots} must be >= 1")
        if superblock < 1:
            raise ValueError(f"superblock={superblock} must be >= 1")
        self.max_slots = int(max_slots)
        self.superblock = int(superblock)
        self._device = (get_device(device).name
                        if isinstance(device, str) else device)
        self._torch_device = require_device(torch_device)
        #: Optional :class:`repro_torch.obs.Tracer` this server installs
        #: around its own admission and stepping work.
        self.tracer = tracer
        self._buckets: dict[BucketKey, _Bucket] = {}
        self._completed: list[SolveRequest] = []
        self._copies: list[_Copy] = []
        self._copier = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve.result_copy")
        self._admitted = 0
        self.warmed: dict[tuple, str] = {}

    def _obs(self):
        """The tracer scope server work runs under (no-op without one)."""
        return (use_tracer(self.tracer) if self.tracer is not None
                else contextlib.nullcontext())

    # ------------------------------------------------------- admission

    def submit(self, req: SolveRequest) -> SolveRequest:
        """Validate, bucket, and enqueue one request.

        Raises :class:`SolveRejected` with structured diagnostics when the
        request cannot be scheduled (``SCHED-REQUEST-INFEASIBLE`` wraps
        planner and budget failures; ``check_schedule`` findings pass
        through verbatim). Admissions bump ``serve.admitted`` and give
        the request the next :attr:`SolveRequest.id`; every rejection
        bumps ``serve.rejected.<CODE>``.
        """
        with self._obs(), _obs_span("serve.submit", policy=req.policy,
                                    max_iters=req.max_iters) as sp:
            req = self._submit(req)
            sp.set(bucket=req.key.describe(), t=req.key.t, request=req.id)
            return req

    def _grid(self, grid) -> torch.Tensor:
        if isinstance(grid, torch.Tensor):
            return grid.to(self._torch_device).contiguous()
        return grid_from_numpy(grid, device=self._torch_device)

    def _submit(self, req: SolveRequest) -> SolveRequest:
        grid = self._grid(req.grid)
        if grid.ndim != 2:
            self._reject(f"grids are 2-D ringed arrays; got shape "
                         f"{tuple(grid.shape)}")
        if req.max_iters < 1:
            self._reject(f"max_iters={req.max_iters} must be >= 1 "
                         f"(nothing to solve)")
        shape = tuple(int(s) for s in grid.shape)
        dtype = dtype_name(grid.dtype)
        where = self._torch_device.type
        try:
            sched = build_schedule(
                req.max_iters, spec=req.spec, shape=shape, dtype=dtype,
                policy=req.policy, t=req.t, device=self._device,
                torch_device=where)
            cadence = effective_depth(req.max_iters, req.t)
            if req.policy != "reference" and sched.policy != "reference":
                # The block runs `cadence` sweeps per call; its schedule
                # and its kernel's plan must validate at that depth too.
                block = build_schedule(
                    cadence, spec=req.spec, shape=shape, dtype=dtype,
                    policy=sched.policy, t=cadence, device=self._device,
                    torch_device=where)
                plan_for(shape, dtype, req.spec, block.policy,
                         t=block.t if block.fused else None,
                         device=self._device)
        except (PlanError, ValueError) as e:
            self._reject(str(e), cause=e)
        report = check_schedule(sched, shape=shape, dtype=dtype,
                                spec=req.spec, device=self._device)
        for d in report.errors:
            _metrics.counter(f"serve.rejected.{d.code}").inc()
        report.raise_if_errors(SolveRejected)

        key = BucketKey(shape=shape, dtype=dtype, spec=req.spec,
                        policy=sched.policy, t=cadence,
                        device=self._device, torch_device=where)
        req.grid = grid
        req.key = key
        req.target_blocks = req.max_iters // cadence
        req.blocks_done = 0
        req.submitted_s = time.perf_counter()
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket(key, self.max_slots)
        bucket.admit(req, key.fields())
        req.id = self._admitted
        self._admitted += 1
        _metrics.counter("serve.admitted").inc()
        return req

    def _reject(self, message: str, cause: Exception | None = None):
        _metrics.counter("serve.rejected.SCHED-REQUEST-INFEASIBLE").inc()
        report = Report((error(
            "SCHED-REQUEST-INFEASIBLE", "request", message,
            hint="resize the grid, lower t, or serve on a device with "
                 "more fast memory"),))
        raise SolveRejected(report.describe()) from cause

    # --------------------------------------------------------- warmup

    def warm(self, shapes, spec: StencilSpec | None = None, *,
             dtype=torch.float32, iters: int = 1, t: int | None = None
             ) -> dict[tuple, str]:
        """Pre-measure the tune cache for the buckets traffic will hit.

        :func:`repro_torch.engine.tune.warm` on the server's device model
        and torch device, so ``policy="tuned"`` requests never pay a
        measurement at admission. Idempotent; returns ``{shape: winner}``
        and records it in :attr:`warmed`.
        """
        from repro_torch.engine import tune
        spec = spec if spec is not None else jacobi_2d_5pt()
        won = tune.warm(shapes, dtype, spec, iters=iters, t=t,
                        torch_device=self._torch_device.type,
                        device=self._device)
        self.warmed.update(won)
        return won

    # -------------------------------------------------------- stepping

    def _zeros(self, n: int, key: BucketKey) -> torch.Tensor:
        return torch.zeros((n,) + key.shape, dtype=getattr(torch, key.dtype),
                           device=self._torch_device)

    def _fill_slots(self, bucket: _Bucket) -> None:
        key = bucket.key
        demand = bucket.active + len(bucket.queue)
        want = min(bucket.max_slots, _next_pow2(max(demand, 1)))
        if want > len(bucket.slots):
            pad = want - len(bucket.slots)
            dummy = self._zeros(pad, key)
            bucket.us = (dummy if bucket.us is None
                         else torch.cat([bucket.us, dummy]))
            bucket.slots.extend([None] * pad)
        elif want < len(bucket.slots):
            # Compact the straggler tail into a narrower slot tensor (an
            # exact copy), so evicted lanes stop paying sweeps.
            keep = [i for i, r in enumerate(bucket.slots) if r is not None]
            idx = _to_device(torch.tensor(keep, dtype=torch.int64),
                             self._torch_device)
            kept = bucket.us.index_select(0, idx)
            pad = want - len(keep)
            if pad:
                kept = torch.cat([kept, self._zeros(pad, key)])
            bucket.us = kept
            bucket.slots = [bucket.slots[i] for i in keep] + [None] * pad
        for i, slot in enumerate(bucket.slots):
            if slot is None and bucket.queue:
                req = bucket.queue.popleft()
                bucket.us[i].copy_(req.grid)
                bucket.slots[i] = req
        bucket.peak_active = max(bucket.peak_active, bucket.active)

    def _evict(self, bucket: _Bucket, i: int, converged: bool) -> None:
        req = bucket.slots[i]
        bucket.slots[i] = None           # the slot is free immediately
        self._stage_result(bucket, req, bucket.us[i], converged)

    def _stage(self, bucket: _Bucket, u: torch.Tensor):
        """Start copying ``u`` into a free buffer of the bucket's staging
        pool, made on first use, ``max_slots`` at most; returns (buffer,
        event). With none free, the bucket's oldest pending copy is
        finished first."""
        if bucket.spent:
            self._finish_copy(next(c for c in self._copies
                                   if c.bucket is bucket))
        if bucket.free:
            buf = bucket.free.pop()
        else:
            buf = _host_buffer(u)
            bucket.staging += 1
        return buf, _copy_out([u], [buf])

    def _host_now(self, bucket: _Bucket, u: torch.Tensor) -> torch.Tensor:
        """``u`` on the host at once, through the pool (a streamed
        iterate, which its callback needs now)."""
        buf, ev = self._stage(bucket, u)
        out = _landed(buf, ev)
        bucket.free.append(buf)
        return out

    def _stage_result(self, bucket: _Bucket, req: SolveRequest,
                      u: torch.Tensor, converged: bool) -> None:
        """Start a finished request's result copy, under a
        ``serve.result_copy`` span that ends with the result on the host
        (:meth:`_finish_copies`). Counts ``serve.result_copy.staged``,
        and ``serve.result_copy.pool_waits`` when the pool has no free
        buffer."""
        sp = _obs_begin("serve.result_copy", request=req.id, bytes=u.nbytes)
        if bucket.spent:
            _metrics.counter("serve.result_copy.pool_waits").inc()
        buf, ev = self._stage(bucket, u)
        _metrics.counter("serve.result_copy.staged").inc()
        job = self._copier.submit(_landed, buf, ev)
        self._copies.append(_Copy(bucket, req, converged, buf, job, sp))

    def _finish_copy(self, c: _Copy) -> None:
        """Wait for a pending copy, free its buffer, finish its request."""
        result = c.job.result()
        self._copies.remove(c)
        c.bucket.free.append(c.buf)
        c.span.end()
        self._finish(c.bucket, c.req, result, c.converged)

    def _finish_copies(self, wait: bool) -> None:
        """Finish the pending copies that have landed, oldest first; with
        ``wait``, every one."""
        for c in list(self._copies):
            if wait or c.job.done():
                self._finish_copy(c)

    def _finish(self, bucket: _Bucket, req: SolveRequest,
                result: torch.Tensor, converged: bool) -> None:
        req.result = result
        req.converged = converged
        req.done = True
        req.finished_s = time.perf_counter()
        bucket.completed += 1
        if converged and req.blocks_done < req.target_blocks:
            bucket.evicted_early += 1
        self._completed.append(req)

    def step(self) -> int:
        """Advance every busy bucket by one superblock (up to
        ``superblock`` blocks of its cadence ``t``).

        Returns the number of launches performed (0 = nothing left to
        launch); a launch is one superblock of a bucket, or one lone
        request's ``run_converged``. Slots freed by eviction are refilled
        from the bucket queue before the next superblock. Every busy
        bucket's superblock is queued first, each with a non-blocking
        readback of its history, and only then are the histories
        replayed, so one bucket's replay overlaps the next bucket's
        kernels. The step ends by finishing the result copies that have
        landed (all of them when it launched nothing): a request is done
        in the step that evicts it or in a later one, its result on the
        host. Each launch runs under a ``serve.block`` span
        (``requests``: the ids in its slots), each finished request's
        copy, from its start to the result on the host, under a
        ``serve.result_copy`` span, and each launch adds a sample of
        active slots and queue to the ``serve.slots`` counter track and
        its evictions to the ``serve.evictions`` counter.
        """
        with self._obs():
            return self._step()

    def _step(self) -> int:
        launches = 0
        pending = []
        for bucket in self._buckets.values():
            if not bucket.busy:
                continue
            if (bucket.active == 0 and len(bucket.queue) == 1
                    and bucket.queue[0].stream is None):
                # Fresh lone request: never touches the slot tensor.
                launches += self._step_lone(bucket)
                continue
            self._fill_slots(bucket)
            if bucket.active == 0:
                continue
            lone = [r for r in bucket.slots if r is not None]
            if (len(lone) == 1 and not bucket.queue
                    and lone[0].stream is None):
                launches += self._step_lone(bucket)
                continue
            launches += self._dispatch_superblock(bucket, pending)
        for bucket, k, out, cm, sp in pending:
            try:
                self._replay(bucket, k, out, sp)
            finally:
                cm.__exit__(None, None, None)
        # With nothing launched, the copies are all that is left to wait on.
        self._finish_copies(wait=not launches)
        return launches

    def _step_lone(self, bucket: _Bucket) -> int:
        """Single-request bypass: one :func:`run_converged` call carries
        the request to convergence or budget at the same ``t``-block
        cadence, with ``tol`` narrowed by :func:`_tol_f32` as on the
        batched path, so it lands exactly where slot serving would. A
        fresh request runs straight off ``req.grid``; one left alone
        mid-flight resumes from its lane."""
        key = bucket.key
        if bucket.active:
            i = next(j for j, r in enumerate(bucket.slots)
                     if r is not None)
            req, u = bucket.slots[i], bucket.us[i]
        else:
            i, req = None, bucket.queue.popleft()
            u = req.grid
            bucket.peak_active = max(bucket.peak_active, 1)
        remaining = req.target_blocks - req.blocks_done
        tol = None if req.tol is None else float(_tol_f32(req.tol))
        with _obs_span("serve.block", bucket=key.describe(),
                       launch=bucket.launches, active=1, queue=0,
                       blocks=remaining, lone=True,
                       requests=[req.id]) as sp:
            v, iters, res = run_converged(
                u, key.spec, tol=tol, max_iters=remaining * key.t,
                policy=key.policy, t=key.t, device=key.device)
            bucket.launches += 1
            req.blocks_done += int(iters) // key.t
            req.iters_done = req.blocks_done * key.t
            req.residual = float(res)
            converged = req.tol is not None and req.residual <= req.tol
            if i is not None:
                bucket.slots[i] = None   # lane is stale; refills overwrite
            self._stage_result(bucket, req, v, converged)
            sp.set(max_residual=req.residual, evicted=1)
        _metrics.counter("serve.evictions").inc(1)
        self._slots_sample(bucket)
        return 1

    def _dispatch_superblock(self, bucket: _Bucket, pending: list) -> int:
        """Queue up to ``superblock`` blocks for one bucket; defer the
        host-side replay until every bucket has been queued."""
        key = bucket.key
        active = [r for r in bucket.slots if r is not None]
        k = max(1, min(self.superblock,
                       max(r.target_blocks - r.blocks_done
                           for r in active)))
        if any(r.stream_iterates for r in active):
            # Streamed iterates are host copies at every block boundary;
            # only a one-block superblock exposes each boundary state.
            k = 1
        n_slots = len(bucket.slots)
        conv0 = torch.zeros(n_slots, dtype=torch.bool)
        n0 = torch.zeros(n_slots, dtype=torch.int32)
        tols = torch.full((n_slots,), -1.0, dtype=torch.float32)
        budgets = torch.zeros(n_slots, dtype=torch.int32)
        for i, r in enumerate(bucket.slots):
            if r is None:
                conv0[i] = True            # empty lanes stay frozen
                continue
            n0[i] = r.blocks_done
            budgets[i] = r.target_blocks
            if r.tol is not None:
                tols[i] = float(_tol_f32(r.tol))
        cm = _obs_span("serve.block", bucket=key.describe(),
                       launch=bucket.launches, active=bucket.active,
                       queue=len(bucket.queue), blocks=k,
                       requests=[r.id for r in active])
        sp = cm.__enter__()
        dev = self._torch_device
        flags = _superblock(bucket, k, *(_to_device(x, dev) for x in
                                         (conv0, n0, tols, budgets)))
        out = _readback(flags, dev)
        bucket.launches += 1
        pending.append((bucket, k, out, cm, sp))
        return 1

    def _replay(self, bucket: _Bucket, k: int, out, sp) -> None:
        """Replay one superblock's per-block history on the host:
        streaming callbacks, iteration accounting, and eviction, the same
        block-boundary events a one-block server fires, after one wait
        for the history's readback."""
        (conv, hist_res, hist_live), ev = out
        if ev is not None:
            ev.synchronize()
        conv_arr = conv.numpy()
        hres = hist_res.numpy()
        hlive = hist_live.numpy()
        t = bucket.key.t
        evicted = 0
        max_residual = 0.0
        for i, req in enumerate(list(bucket.slots)):
            if req is None:
                continue
            for j in range(k):
                if not hlive[j, i]:
                    continue
                req.blocks_done += 1
                req.iters_done = req.blocks_done * t
                req.residual = float(hres[j, i])
                max_residual = max(max_residual, req.residual)
                if req.stream is not None:
                    iterate = (self._host_now(bucket, bucket.us[i])
                               if req.stream_iterates else None)
                    req.stream(req, SolveProgress(req.iters_done,
                                                  req.residual, iterate))
            converged = bool(conv_arr[i])
            if converged or req.blocks_done >= req.target_blocks:
                self._evict(bucket, i, converged)
                evicted += 1
        sp.set(max_residual=max_residual, evicted=evicted)
        if evicted:
            _metrics.counter("serve.evictions").inc(evicted)
        self._slots_sample(bucket)

    def _slots_sample(self, bucket: _Bucket) -> None:
        tracer = get_tracer()
        if tracer is not None:
            tracer.counter("serve.slots", {"active": bucket.active,
                                           "queue": len(bucket.queue)})

    @property
    def busy(self) -> bool:
        """Work left: a request queued or in a slot, or a result still on
        its way to the host."""
        return bool(self._copies) or any(b.busy
                                         for b in self._buckets.values())

    def drain(self, max_launches: int = 1_000_000) -> list[SolveRequest]:
        """Step until every admitted request has completed, its result on
        the host."""
        while self.busy:
            if max_launches <= 0:
                raise RuntimeError("drain exceeded its launch budget")
            max_launches -= self.step()
        return list(self._completed)

    def solve(self, requests) -> list[SolveRequest]:
        """Submit a batch of requests and drain the server; returns the
        same request objects (results filled in), in the caller's order."""
        reqs = list(requests)
        for r in reqs:
            self.submit(r)
        self.drain()
        return reqs

    # ------------------------------------------------------ inspection

    @property
    def buckets(self) -> tuple[BucketKey, ...]:
        return tuple(self._buckets)

    def stats(self) -> dict:
        """Aggregate serving counters (per bucket + totals)."""
        per = {
            b.key.describe(): {
                "launches": b.launches, "completed": b.completed,
                "evicted_early": b.evicted_early,
                "peak_active": b.peak_active, "slots": len(b.slots),
            } for b in self._buckets.values()
        }
        return {
            "buckets": len(self._buckets),
            "launches": sum(b.launches for b in self._buckets.values()),
            "completed": sum(b.completed for b in self._buckets.values()),
            "evicted_early": sum(b.evicted_early
                                 for b in self._buckets.values()),
            "per_bucket": per,
        }
