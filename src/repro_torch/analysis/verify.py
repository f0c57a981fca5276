"""Static verification of :class:`~repro_torch.backends.ir.TensixProgram`.

Proves, without executing a program, the properties the functional
simulator would otherwise only falsify mid-run (and real hardware would
falsify by hanging):

* **CB occupancy** — an abstract interpretation of every kernel's
  push/pop sequence per block iteration. Entry geometry (rows, cols,
  tiles) is fully static, so the FIFO state is tracked *exactly*:
  min/max occupancy intervals per circular buffer, overflow/underflow
  rejected with a counterexample trace (which op, which block iteration,
  occupancy at failure). Unlike the simulator — which resets CB state at
  every grid block — the interpretation persists state across block
  iterations the way hardware does, iterating until a steady state
  repeats, the plan's block count is exhausted, or the protocol fails;
  acceptance is therefore *stronger* than a clean simulation.
* **Deadlock detection** — a cross-kernel producer/consumer cycle
  (reader/compute/writer each blocked on a CB the other feeds) is
  reported as ``DL-CYCLE``; mismatched per-iteration push/pop rates that
  stall only after ``k`` iterations are reported as ``DL-RATE`` with
  ``k``.
* **Address bounds** — every :class:`ReadBlock`/:class:`WriteBlock`
  block-relative window is checked against the grid/mask stream extents
  for *all* block indices ``i`` (``row0 = r + i*bm``), so ragged-edge and
  ``t*r``-halo window arithmetic is proven in-range, not spot-checked.
* **Device budgets** — the summed CB footprint vs per-core SRAM
  (``BUD-SRAM``) and the CB count vs the device's CB file
  (``BUD-CBFILE``), formatted like every other budget error.

``lower_plan`` runs :func:`verify_program` on every program it builds and
``sim.run_program`` refuses unverified-unsound programs, so a program
that reaches execution is guaranteed not to raise ``CBOverflowError`` /
``CBUnderflowError`` at runtime — the property ``tests/test_analysis.py``
fuzzes.

The port's copy of ``repro.analysis.verify``: pure Python over the port's
IR, with the reference's codes, messages and bounds.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.analysis.diagnostics import (Diagnostic, Report,
                                              budget_message, error, warning)
from repro_torch.backends.ir import (BackendError, CBOverflowError,
                                     CBUnderflowError, LocalSweeps,
                                     ReadBlock, TapCombine, TapReduce,
                                     TensixProgram, Tilize, Untilize,
                                     WriteBlock, _op_str, tile_grid)

#: Upper bound on interpreted block iterations, far above any real
#: ``plan.nblocks``; a backstop against pathological hand-built programs.
MAX_ITERATIONS = 4096


@dataclasses.dataclass(frozen=True)
class CBBounds:
    """Static occupancy interval of one circular buffer, in tiles."""

    min_tiles: int
    max_tiles: int
    capacity: int

    def describe(self) -> str:
        return f"occ[{self.min_tiles},{self.max_tiles}]/{self.capacity}"


# ---------------------------------------------------------------------------
# Op semantics: the exact push/pop events sim._run_block performs.
# ---------------------------------------------------------------------------

def _kernels(prog: TensixProgram):
    return (("reader", prog.reader), ("compute", prog.compute),
            ("writer", prog.writer))


def _op_events(prog: TensixProgram, op) -> list[tuple[str, str]]:
    """``("push"|"pop", cb_name)`` events one execution of ``op`` makes,
    in simulator order."""
    if isinstance(op, ReadBlock):
        return [("push", op.cb)]
    if isinstance(op, (Tilize, Untilize)):
        return [("pop", op.src), ("push", op.dst)]
    if isinstance(op, TapReduce):
        return [("pop", op.src), ("push", op.dst)]
    if isinstance(op, TapCombine):
        # The simulator zips srcs with the spec weights: extra srcs beyond
        # the tap count are never popped (and starve their producer).
        n = min(len(op.srcs), prog.spec.taps)
        return [("pop", s) for s in op.srcs[:n]] + [("push", op.dst)]
    if isinstance(op, LocalSweeps):
        ev = [("pop", op.src)]
        if op.mask is not None:
            ev.append(("pop", op.mask))
        ev.append(("push", op.dst))
        return ev
    if isinstance(op, WriteBlock):
        return [("pop", op.cb)]
    return []


def _push_shape(prog: TensixProgram, op, popped: list) -> tuple[int, int]:
    """(rows, cols) of the entry ``op`` pushes, given the entries it just
    popped (geometry propagates exactly like the simulator's arrays)."""
    if isinstance(op, ReadBlock):
        return (op.rows, op.cols)
    if isinstance(op, (Tilize, Untilize)):
        return popped[0]
    if isinstance(op, TapReduce):
        return (op.out_rows, op.out_cols)
    if isinstance(op, TapCombine):
        return popped[0]
    if isinstance(op, LocalSweeps):
        return (prog.plan.bm, popped[0][1])
    raise AssertionError(op)


@dataclasses.dataclass
class _Failure:
    code: str
    cb: str
    kernel: str
    op_index: int
    op: object
    iteration: int
    occupancy: int
    detail: str


# ---------------------------------------------------------------------------
# Pass 1: structure (declared CBs, fed CBs) — diagnostics, never raises.
# ---------------------------------------------------------------------------

def _structural_pass(prog: TensixProgram, diags: list[Diagnostic]) -> bool:
    names = {cb.name for cb in prog.cbs}
    ok = True
    pushed: set[str] = set()
    for kernel, ops in _kernels(prog):
        for idx, op in enumerate(ops):
            span = f"{kernel}[{idx}] {type(op).__name__}"
            for kind, cb in _op_events(prog, op):
                if cb not in names:
                    diags.append(error(
                        "CB-UNDECLARED", span,
                        f"op references undeclared CB {cb!r}; declared: "
                        f"{sorted(names)}",
                        hint="declare the CB in program.cbs or fix the "
                             "op's buffer name"))
                    ok = False
                elif kind == "push":
                    pushed.add(cb)
    if not ok:
        return False
    for kernel, ops in _kernels(prog):
        for idx, op in enumerate(ops):
            for kind, cb in _op_events(prog, op):
                if kind == "pop" and cb not in pushed:
                    diags.append(error(
                        "CB-UNFED", f"{kernel}[{idx}] {type(op).__name__}",
                        f"{kernel} pops {cb!r} but no op in any kernel "
                        f"pushes to it — the consumer blocks forever",
                        hint="add the producing read/compute op, or drop "
                             "the consumer"))
                    ok = False
    return ok


# ---------------------------------------------------------------------------
# Pass 2: deadlock — cross-kernel wait cycles and push/pop rate drift.
# ---------------------------------------------------------------------------

def _deadlock_pass(prog: TensixProgram, diags: list[Diagnostic]) -> None:
    producers: dict[str, set[str]] = {}
    consumers: dict[str, set[str]] = {}
    for kernel, ops in _kernels(prog):
        for op in ops:
            for kind, cb in _op_events(prog, op):
                (producers if kind == "push" else consumers) \
                    .setdefault(cb, set()).add(kernel)
    # kernel A waits on kernel B when A pops a CB only B pushes.
    edges: dict[str, set[tuple[str, str]]] = {}
    for cb, cons in consumers.items():
        for c in cons:
            for p in producers.get(cb, set()):
                if p != c:
                    edges.setdefault(c, set()).add((p, cb))
    seen_cycles = set()
    for start in ("reader", "compute", "writer"):
        path: list[tuple[str, str]] = []
        stack: list[str] = [start]

        def walk(node):
            for nxt, via in sorted(edges.get(node, ())):
                if nxt in stack:
                    cyc = stack[stack.index(nxt):] + [via]
                    key = frozenset(cyc[:-1])
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        chain = " -> ".join(stack[stack.index(nxt):]
                                            + [nxt])
                        cbs = sorted({v for _, v in path + [(nxt, via)]})
                        diags.append(error(
                            "DL-CYCLE", "program",
                            f"kernel wait cycle {chain} (through CBs "
                            f"{cbs}): each kernel blocks on a CB the "
                            f"other must feed — the pipeline deadlocks "
                            f"before the first block completes",
                            hint="break the cycle: a kernel may only "
                                 "consume CBs produced upstream of it in "
                                 "the reader->compute->writer pipeline"))
                    continue
                stack.append(nxt)
                path.append((nxt, via))
                walk(nxt)
                path.pop()
                stack.pop()

        walk(start)


def _rate_counts(prog: TensixProgram) -> tuple[dict, dict]:
    pushes: dict[str, int] = {}
    pops: dict[str, int] = {}
    for _, ops in _kernels(prog):
        for op in ops:
            for kind, cb in _op_events(prog, op):
                d = pushes if kind == "push" else pops
                d[cb] = d.get(cb, 0) + 1
    return pushes, pops


# ---------------------------------------------------------------------------
# Pass 3: address bounds — every block index, not just the tested ones.
# ---------------------------------------------------------------------------

def _bounds_pass(prog: TensixProgram, diags: list[Diagnostic]) -> None:
    plan = prog.plan
    h, w = plan.shape
    r = plan.spec.radius
    bm, nblocks = plan.bm, plan.nblocks
    for kernel, ops in _kernels(prog):
        for idx, op in enumerate(ops):
            if not isinstance(op, (ReadBlock, WriteBlock)):
                continue
            span = f"{kernel}[{idx}] {_op_str(op).split()[0]}" \
                   f"{'->' if isinstance(op, ReadBlock) else '<-'}{op.cb}"
            stream = getattr(op, "src", "grid")
            if op.col0 < 0 or op.col0 + op.cols > w:
                diags.append(error(
                    "AB-COL", span,
                    f"column window [{op.col0},{op.col0 + op.cols}) leaves "
                    f"the {stream} stream's [0,{w}) extent",
                    hint="clamp col0/cols to the padded tile grid the "
                         "stream actually stores"))
            clamp = getattr(op, "clamp", False)
            if clamp:
                # The simulator clips start into [0, h-rows]; in-range for
                # every block iff the window itself fits the stream.
                if op.rows > h:
                    diags.append(error(
                        "AB-ROW", span,
                        f"clamped window of {op.rows} rows exceeds the "
                        f"{stream} stream's {h} total rows",
                        hint="shrink the window (lower bm or t)"))
                continue
            # row0 = r + i*bm; start monotonically increases with i, so
            # the extremes certify every block index.
            start0 = r + op.dy
            end_last = r + (nblocks - 1) * bm + op.dy + op.rows
            if start0 < 0:
                diags.append(error(
                    "AB-ROW", span,
                    f"rows [{start0},{start0 + op.rows}) at block 0 start "
                    f"above the {stream} stream (dy={op.dy:+d} reaches "
                    f"past the radius-{r} ring)",
                    hint="set clamp=True for boundary blocks or shrink "
                         "|dy| to <= the ring depth"))
            if end_last > h:
                # The smallest violating block index is the counterexample.
                i_bad = 0
                if bm > 0:
                    i_bad = max(0, -(-(h - r - op.dy - op.rows + 1) // bm))
                diags.append(error(
                    "AB-ROW", span,
                    f"rows [{r + i_bad * bm + op.dy},"
                    f"{r + i_bad * bm + op.dy + op.rows}) at block "
                    f"{i_bad}/{nblocks} run past the {stream} stream's "
                    f"{h} rows",
                    hint="set clamp=True for boundary blocks, or fix the "
                         "dy/rows arithmetic against the halo depth"))


# ---------------------------------------------------------------------------
# Pass 4: occupancy — exact FIFO abstract interpretation.
# ---------------------------------------------------------------------------

def _interpret(prog: TensixProgram
               ) -> tuple[dict[str, CBBounds], _Failure | None, int]:
    """Abstractly execute the program's push/pop protocol.

    Returns (per-CB occupancy bounds, first failure or None, iterations
    interpreted). State persists across block iterations (hardware
    semantics — strictly harder than the simulator's per-block reset);
    the loop stops at a repeated steady state, ``plan.nblocks``
    iterations, or the first failure.
    """
    dev = prog.plan.device
    caps = {cb.name: cb.capacity_tiles for cb in prog.cbs}
    queues: dict[str, list[tuple[int, int, int]]] = \
        {cb.name: [] for cb in prog.cbs}
    occ = {cb.name: 0 for cb in prog.cbs}
    lo = dict(occ)
    hi = dict(occ)
    nblocks = max(prog.plan.nblocks, 1)
    iterations = min(nblocks, MAX_ITERATIONS)
    seen_states: set = set()

    def ntiles(rows: int, cols: int) -> int:
        nty, ntx = tile_grid(rows, cols, dev.tile_rows, dev.tile_cols)
        return nty * ntx

    for i in range(iterations):
        for kernel, ops in _kernels(prog):
            for idx, op in enumerate(ops):
                popped: list[tuple[int, int]] = []
                for kind, cb in _op_events(prog, op):
                    if kind == "pop":
                        if not queues[cb]:
                            later_push = any(
                                ("push", cb) in _op_events(prog, o2)
                                for _, ops2 in _kernels(prog)
                                for o2 in ops2)
                            return dict_bounds(lo, hi, caps), _Failure(
                                "CB-UNDERFLOW", cb, kernel, idx, op, i,
                                occ[cb],
                                "a later op does push this CB — ops "
                                "execute in list order; move the "
                                "producer before the consumer"
                                if later_push else
                                "no resident entry and none pending"), i
                        rows, cols, n = queues[cb].pop(0)
                        occ[cb] -= n
                        lo[cb] = min(lo[cb], occ[cb])
                        popped.append((rows, cols))
                    else:
                        rows, cols = _push_shape(prog, op, popped)
                        n = ntiles(rows, cols)
                        if occ[cb] + n > caps[cb]:
                            return dict_bounds(lo, hi, caps), _Failure(
                                "CB-OVERFLOW", cb, kernel, idx, op, i,
                                occ[cb],
                                f"pushing {n} tiles onto {occ[cb]} "
                                f"resident exceeds capacity {caps[cb]}"), i
                        queues[cb].append((rows, cols, n))
                        occ[cb] += n
                        hi[cb] = max(hi[cb], occ[cb])
        sig = tuple((name, tuple(queues[name])) for name in sorted(queues))
        if sig in seen_states:
            break  # steady state: all remaining iterations are identical
        seen_states.add(sig)
    return dict_bounds(lo, hi, caps), None, iterations


def dict_bounds(lo: dict, hi: dict, caps: dict) -> dict[str, CBBounds]:
    return {name: CBBounds(lo[name], hi[name], caps[name]) for name in caps}


def _occupancy_pass(prog: TensixProgram, diags: list[Diagnostic]
                    ) -> dict[str, CBBounds]:
    bounds, failure, _ = _interpret(prog)
    pushes, pops = _rate_counts(prog)
    if failure is not None:
        op_desc = _op_str(failure.op)
        span = f"{failure.kernel}[{failure.op_index}] {op_desc}"
        persist = (" (the simulator resets CBs per block; hardware does "
                   "not — the drift is real on-device)"
                   if failure.iteration > 0 else "")
        if failure.code == "CB-OVERFLOW":
            diags.append(error(
                "CB-OVERFLOW", span,
                f"CB {failure.cb!r} overflow: {failure.detail} at block "
                f"iteration {failure.iteration}{persist}",
                hint="grow the CB's capacity/slots, or drain it with a "
                     "matching pop each iteration"))
        else:
            diags.append(error(
                "CB-UNDERFLOW", span,
                f"CB {failure.cb!r} underflow: pop with "
                f"{failure.occupancy} tiles resident and no pending entry "
                f"at block iteration {failure.iteration} — "
                f"{failure.detail}",
                hint="push before popping, or drop the extra consumer"))
    for cb in sorted(pushes.keys() | pops.keys()):
        np_, nq = pushes.get(cb, 0), pops.get(cb, 0)
        if np_ == nq:
            continue
        if nq == 0:
            msg = (f"CB {cb!r} is pushed {np_}x per block iteration but "
                   f"never popped")
        elif np_ == 0:
            continue  # CB-UNFED already reported
        else:
            msg = (f"CB {cb!r} sees {np_} push(es) but {nq} pop(s) per "
                   f"block iteration")
        if failure is not None and failure.cb == cb:
            diags.append(error(
                "DL-RATE", f"cb {cb}",
                f"{msg}; occupancy drifts every iteration and the "
                f"pipeline stalls at block iteration {failure.iteration}",
                hint="balance the per-iteration push/pop counts between "
                     "producer and consumer kernels"))
        else:
            diags.append(warning(
                "DL-RATE", f"cb {cb}",
                f"{msg}; safe for this plan's {prog.plan.nblocks} "
                f"block(s) but drifts on longer grids",
                hint="balance the per-iteration push/pop counts between "
                     "producer and consumer kernels"))
    return bounds


# ---------------------------------------------------------------------------
# Pass 5: device budgets (the checks lower.py used to inline).
# ---------------------------------------------------------------------------

def _budget_pass(prog: TensixProgram, diags: list[Diagnostic]) -> None:
    dev = prog.plan.device
    if len(prog.cbs) > dev.cb_count:
        diags.append(error(
            "BUD-CBFILE", "program",
            f"policy {prog.policy!r} needs {len(prog.cbs)} circular "
            f"buffers ({', '.join(c.name for c in prog.cbs)}); {dev.name} "
            f"has {dev.cb_count} per core",
            hint="fuse staging buffers or pick a policy with fewer "
                 "streams"))
    if prog.sram_bytes > dev.fast_memory_bytes:
        slots = max((c.slots for c in prog.cbs), default=1)
        diags.append(error(
            "BUD-SRAM", "program",
            budget_message(
                f"policy {prog.policy!r} CB layout (tile padding + "
                f"{slots}-slot CBs)", prog.sram_bytes, dev),
            hint="lower bm or t"))


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def verify_program(prog: TensixProgram) -> Report:
    """Statically verify a program; cached per (frozen, hashable) program.

    Returns a :class:`Report`; ``report.ok`` means the program provably
    cannot overflow/underflow a CB, deadlock, or access out of stream
    bounds on any block, and fits its device's SRAM/CB budgets.
    """
    diags: list[Diagnostic] = []
    if _structural_pass(prog, diags):
        _deadlock_pass(prog, diags)
        _bounds_pass(prog, diags)
        _occupancy_pass(prog, diags)
    _budget_pass(prog, diags)
    return Report(tuple(diags))


def occupancy_bounds(prog: TensixProgram) -> dict[str, CBBounds] | None:
    """Static per-CB occupancy intervals, or None when the protocol is too
    broken to interpret (undeclared CBs)."""
    diags: list[Diagnostic] = []
    if not _structural_pass(prog, diags):
        return None
    bounds, _, _ = _interpret(prog)
    return bounds


_EXC_FOR_CODE = {"CB-OVERFLOW": CBOverflowError,
                 "CB-UNDERFLOW": CBUnderflowError,
                 "CB-UNFED": CBUnderflowError}

#: Codes the *runtime* gate enforces: protocol violations the simulator
#: would otherwise hit mid-run (or hardware would hang on). Device-budget
#: codes are enforced at lowering time instead — hand-built microbench
#: programs (``make_copy_program``'s §V access-pattern streams) model
#: DMA traffic at block granularity and intentionally exceed a single
#: core's residency, exactly as they always have.
PROTOCOL_PREFIXES = ("CB-", "DL-", "AB-")


def raise_if_rejected(prog: TensixProgram) -> Report:
    """Verify and raise the matching backend error on a protocol rejection.

    The exception type mirrors what the runtime would eventually have
    raised (``CBOverflowError``/``CBUnderflowError`` for protocol
    violations, ``BackendError`` otherwise), so callers that guarded the
    dynamic failure keep working — they just fail *before* execution,
    with the static counterexample in the message.
    """
    report = verify_program(prog)
    protocol = [d for d in report.errors
                if d.code.startswith(PROTOCOL_PREFIXES)]
    if protocol:
        raise _EXC_FOR_CODE.get(protocol[0].code,
                                BackendError)(report.describe())
    return report
