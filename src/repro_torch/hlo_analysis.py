"""Loop-aware cost of a program: the twin of ``repro.hlo_analysis``, read
from the aten-op stream, not from HLO text.

The reference parses XLA's optimized HLO, recovers while-loop trip counts
(``_trip_count``) because ``cost_analysis`` visits a loop body once, and
walks the call graph. The port has no compiled program: it runs one.
:class:`CostCounter`, a ``TorchDispatchMode``, sees every aten op the
program dispatches, on any device (``meta`` included: shapes, no
storage), and fills the reference's :class:`LoopAwareCost`:

* ``dot_flops``: ``2 * prod(out) * prod(contracted)`` for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot`` and ``convolution`` (and its
  backward), which are what ``einsum``, ``matmul`` and ``linear``
  dispatch to; the bias of ``addmm``/``baddbmm`` is not counted, as XLA's
  separate add is not;
* ``hbm_proxy_bytes``: twice the output bytes of the ops the reference
  counts as materializing (``_MATERIALIZING``, mapped to aten names in
  :data:`MATERIALIZING`). The reference also counts each XLA fusion's
  result, so a fused elementwise chain once; eager PyTorch has no
  fusions, and the port counts no elementwise op, but counts every dtype
  cast (``_to_copy``) and ``clone`` as a copy. Neither is traffic: on the
  smoke cells the port's proxy is 0.09-1.09 of the reference's CPU
  compile's (``tests/test_torch_roofline.py`` pins each cell's ratio and
  says where the two part);
* ``collective_bytes``: the collectives the program issues, priced per
  device with the reference's ring factors (``_collective_bytes``) at
  the size of the op's group: a partitioned program (DTensors on a
  ``DeviceMesh``, ``dist.sharding``) issues ``_c10d_functional``'s
  ``all_gather_into_tensor`` (the gathered result times ``(n-1)/n``),
  ``reduce_scatter_tensor`` (the scattered result times ``n-1``),
  ``all_reduce`` (twice the result times ``(n-1)/n``),
  ``all_to_all_single`` and DTensor's ``shard_dim_alltoall`` (the result
  times ``(n-1)/n``), and their coalesced forms; ``wait_tensor`` is no
  traffic. ``collective_by_op`` holds them under the reference's HLO
  names (``all-gather``, ...), ``collective_count`` counts the ops, and
  each adds twice its result to the HBM proxy, as the reference's walk
  does. ``cross_pod_bytes`` holds the share of each collective's bytes
  that crosses pods (``pod_size`` ranks a pod, :func:`cross_pod_share`):
  of a ring over the group's ranks in order, the hops that join two
  pods over all its hops (2 of 32 for the multipod ``pod.data`` group,
  all of a group over the ``pod`` axis alone, none inside a pod). That
  is the traffic a schedule that reduces inside each pod first sends
  across; a flat ring waits on its cross-pod hop for all of its bytes,
  so ``roofline.analyze``'s DCI term is a lower bound for it. The
  reference counts all of a group's bytes once the group is larger
  than ``pod_size`` instead: XLA flattens a collective over several
  mesh axes into one group, while DTensor issues one a mesh dimension
  (at most 32 ranks on the production meshes), so that rule would find
  no cross-pod bytes here. An unpartitioned program in
  one process has none (shards of an in-process mesh move by ``copy_``,
  counted with the copies).

Partitioned programs: a DTensor op reaches the counter first with the
global shapes; the counter declines it (``NotImplemented``), DTensor
propagates the layouts and runs the local op and the collectives, and
those reach the counter: every term is this rank's, per device, from
the local shapes (the fake group's rank 0 on ``meta``: ``launch.mesh``).
DTensor derives an output's global shape by running the op under a fake
mode; those ops are not the program's and are neither counted nor
tracked.

Loops: eager dispatch is loop-aware by construction. A layer loop, an
accumulation loop or a checkpoint's recompute dispatches every op it
runs, so nothing is multiplied by a trip count.

Kernels: the port's kernels are extension calls; aten never sees their
arithmetic. Each kernel wrapper that can be on an LM path hands the
counter its arguments (:meth:`CostCounter.kernel`, through the launch
observers of ``kernels.build``, where the counter registers itself while
it runs) and the counter applies its formula (:data:`FORMULAS`): K8
(``flash_attention_local``) and K7 (``conv1d_depthwise_causal``), whose
own ops are then not counted. K8's FLOPs are the function's two dots
(``Q K^T`` and ``P V``, ``2 * hd`` each a (query row, key) pair) over the
key tiles the kernel visits: a CTA of ``128 // G`` query positions reads
key tiles (128 keys, 64 at hd 256, for bf16; 32 for f32) up to its last
query under the causal mask, so the count is the block-causal work, a
little more than the exact triangle; the kernel's padding (hd 80 and 112
run in hd 128's layout) and its second ``P V`` product (bf16's ``P_lo``,
f32's split TF32) are not counted. The reference's HLO walk sees a
Pallas kernel as a custom call with no dots, so its count of the same
program on the flash route misses the attention FLOPs altogether. K7
has no dot FLOPs; its bytes are its inputs read once and its output
written once, as are K8's. A program that launches any other kernel
under the counter raises :class:`UncountedKernelError` at the launch
(``build.load`` tells the observer of every launch): the counter never
under-counts silently.

Speed: on ``meta`` tensors most of an op's time is its shape function
(many are written in Python). The counter keeps the metadata of each
fresh ``meta`` output by the op and its inputs' metadata, and makes a
later call of the same op on inputs of the same metadata an empty
``meta`` tensor of that metadata, which is what the shape function would return; ops that
write an input or return a view always run.

Memory: the counter also tracks the storages that ops create (an op whose
output aliases no input: a fresh allocation), from the op that makes one
to the moment it is freed; ``peak_bytes`` is the most alive at once. On
``meta`` this is what the program would hold beyond its inputs.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import build

_DOT_OPS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot")

#: The reference's ``_MATERIALIZING`` HLO ops and the aten ops that stand
#: for each.
MATERIALIZING = {
    "dot": _DOT_OPS,
    "convolution": ("convolution", "convolution_backward"),
    "copy": ("copy_", "_to_copy", "clone", "_copy_from"),
    "dynamic-update-slice": ("slice_scatter", "select_scatter"),
    "dynamic-slice": ("narrow_copy", "slice_copy"),
    "reduce": ("sum", "mean", "amax", "amin", "max", "min", "prod", "any",
               "all", "argmax", "argmin", "var", "std", "var_mean",
               "std_mean", "logsumexp", "norm", "linalg_vector_norm"),
    "transpose": ("permute_copy", "transpose_copy", "t_copy"),
    "concatenate": ("cat", "stack"),
    "scatter": ("scatter", "scatter_", "scatter_add", "scatter_add_",
                "scatter_reduce", "index_add", "index_add_", "index_put",
                "index_put_", "index_copy", "masked_scatter"),
    "gather": ("gather", "index", "index_select", "embedding", "take",
               "take_along_dim"),
    "select-and-scatter": ("max_pool2d_with_indices_backward",),
    "sort": ("sort", "topk"),
    "pad": ("constant_pad_nd", "reflection_pad1d", "replication_pad1d"),
}
_MATERIALIZING_ATEN = frozenset(n for ns in MATERIALIZING.values()
                                for n in ns)


#: The collectives the counter prices, by op name: (the reference's HLO
#: name, where the group's name is among the op's arguments).
COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_reduce": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "all_to_all_single": ("all-to-all", 3),
    "shard_dim_alltoall": ("all-to-all", 3),
}


def _group_ranks(name: str) -> tuple[int, ...]:
    """The global ranks of the process group named ``name``."""
    pg = dist.distributed_c10d._resolve_process_group(name)
    return tuple(dist.get_process_group_ranks(pg))


def cross_pod_share(ranks, pod_size: int) -> float:
    """The share of a ring over ``ranks`` (in rank order) whose hops join
    two pods of ``pod_size`` ranks: 0 for a group inside one pod."""
    rs = sorted(ranks)
    n = len(rs)
    return sum(rs[i] // pod_size != rs[(i + 1) % n] // pod_size
               for i in range(n)) / n


def collective_bytes(op: str, result_bytes: float, n: int) -> float:
    """Bytes a device moves for one collective ``op`` (the reference's
    HLO name) whose result is ``result_bytes`` on a group of ``n``: the
    reference's ring factors (``repro.hlo_analysis._collective_bytes``)."""
    n = max(2, n)
    ring = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * result_bytes * ring
    if op == "reduce-scatter":
        return result_bytes * (n - 1)
    if op in ("all-gather", "all-to-all"):
        return result_bytes * ring
    return float(result_bytes)  # collective-permute


class UncountedKernelError(RuntimeError):
    """A kernel the counter has no formula for was launched under it."""


@dataclasses.dataclass
class LoopAwareCost:
    dot_flops: float = 0.0
    collective_bytes: float = 0.0
    cross_pod_bytes: float = 0.0
    hbm_proxy_bytes: float = 0.0
    collective_by_op: dict = dataclasses.field(default_factory=dict)
    collective_count: int = 0
    # The port's own: kernel calls by name, the ops dispatched, and the
    # most bytes of storages made by the program alive at once.
    kernels: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    peak_bytes: int = 0


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def _dot_flops(name: str, args, out) -> float:
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a = args[0]
    return 2.0 * out.numel() * (a.shape[-1] if a.dim() else 1)


def _conv_flops(name: str, args, out) -> float:
    if name == "convolution":
        x, w, transposed = args[0], args[1], args[6]
        if transposed:
            return 2.0 * x.numel() * _numel(w.shape[1:])
        return 2.0 * out.numel() * _numel(w.shape[1:])
    # convolution_backward(grad_out, input, weight, ..., output_mask)
    grad_out, x, w = args[0], args[1], args[2]
    transposed, mask = args[7], args[10]
    fwd = 2.0 * (x.numel() if transposed else grad_out.numel()) \
        * _numel(w.shape[1:])
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)


def flash_cost(q: torch.Tensor, k: torch.Tensor,
               causal: bool) -> tuple[float, float]:
    """(dot FLOPs, bytes) of one K8 call: see the module note."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    tq = 128 // g
    bn = (64 if hd == 256 else 128) if q.dtype == torch.bfloat16 else 32
    pairs = 0
    for q0 in range(0, sq, tq):
        rows = min(tq, sq - q0) * g
        k_end = min(sk, q0 + tq) if causal else sk  # min(Sk, q_last + 1)
        pairs += rows * min(-(-k_end // bn) * bn, sk)
    flops = 4.0 * hd * pairs * b * kh
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return flops, float(nbytes)


def conv1d_cost(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None) -> tuple[float, float]:
    """(dot FLOPs, bytes) of one K7 call: no dots; inputs read once and
    the output written once."""
    nbytes = (2 * x.numel() + w.numel()
              + (0 if b is None else b.numel())) * x.element_size()
    return 0.0, float(nbytes)


#: The cost formula of each kernel the counter counts, by the name its
#: wrapper hands to :meth:`CostCounter.kernel`.
FORMULAS = {"flash_attention": flash_cost, "conv1d": conv1d_cost}


_UNKEYED = object()


def _meta_key(x):
    """A hashable key of an op argument's metadata, or ``_UNKEYED`` when
    the op's result may depend on more than metadata (a tensor off
    ``meta``, an argument of a kind not listed)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            return _UNKEYED
        return (x.dtype, tuple(x.shape), x.stride(), x.storage_offset())
    if isinstance(x, (tuple, list)):
        keys = tuple(_meta_key(e) for e in x)
        return _UNKEYED if any(k is _UNKEYED for k in keys) \
            else (type(x), keys)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return x
    return _UNKEYED


def _pure(func) -> bool:
    """Whether ``func`` writes no argument and returns only fresh
    tensors."""
    schema = func._schema
    return (not any(a.alias_info is not None and a.alias_info.is_write
                    for a in schema.arguments)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in schema.returns))


def _faking(types) -> bool:
    """Whether an op runs on fake tensors, or under a fake mode (DTensor's
    shape propagation)."""
    return (any(issubclass(t, FakeTensor) for t in types)
            or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None)


class CostCounter(TorchDispatchMode):
    """Counts the cost of what runs under it (``with CostCounter() as c``;
    then ``c.cost``). See the module note; ``pod_size`` ranks make a pod
    (None: no pods, no cross-pod bytes)."""

    def __init__(self, pod_size: int | None = None):
        super().__init__()
        self.pod_size = pod_size
        self._groups: dict = {}  # group name -> its global ranks
        self.cost = LoopAwareCost()
        self._in_kernel = False
        self._live = 0
        self._tracked: dict[int, int] = {}  # id(storage) -> bytes
        self._shapes: dict = {}  # (op, args' metadata) -> outputs'
        self._pure: dict = {}    # op -> _pure(op)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, from the shape cache on ``meta``."""
        pure = self._pure.get(func)
        if pure is None:
            pure = self._pure[func] = _pure(func)
        key = None
        if pure:
            key = (func, _meta_key(args),
                   _meta_key(tuple(sorted(kwargs.items()))))
            if _UNKEYED in key[1:]:
                key = None
        hit = self._shapes.get(key) if key is not None else None
        if hit is not None:
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in hit]
            return outs[0] if len(outs) == 1 else tuple(outs)
        out = func(*args, **kwargs)
        if key is not None:
            outs = out if isinstance(out, tuple) else (out,)
            if all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   for t in outs):
                self._shapes[key] = [(t.shape, t.stride(), t.dtype)
                                     for t in outs]
        return out

    def __enter__(self):
        build.OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            build.OBSERVERS.remove(self)

    # -- memory -----------------------------------------------------------

    def _freed(self, key: int) -> None:
        self._live -= self._tracked.pop(key, 0)

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = n
        self._live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
        weakref.finalize(st, self._freed, key)

    def tracked(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was made under the counter and is
        alive."""
        return id(t.untyped_storage()) in self._tracked

    # -- ops and kernels --------------------------------------------------

    def _collective(self, name: str, args, outs) -> None:
        op, at = COLLECTIVES[name]
        group = args[at]
        ranks = self._groups.get(group)
        if ranks is None:
            ranks = self._groups[group] = _group_ranks(group)
        b = collective_bytes(op, sum(t.numel() * t.element_size()
                                     for t in outs), len(ranks))
        c = self.cost
        c.collective_bytes += b
        c.collective_by_op[op] = c.collective_by_op.get(op, 0.0) + b
        c.collective_count += 1
        if self.pod_size:
            c.cross_pod_bytes += b * cross_pod_share(ranks, self.pod_size)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # counted as DTensor's local ops
        if func.overloadpacket.__name__ == "wait_tensor" or _faking(types):
            # no traffic; DTensor's shape propagation (global shapes)
            return func(*args, **(kwargs or {}))
        out = self._run(func, args, kwargs or {})
        if self._in_kernel:
            return out
        name = func.overloadpacket.__name__
        c = self.cost
        c.ops += 1
        if name in COLLECTIVES:
            outs = list(_tensors(out))
            self._collective(name, args, outs)
            c.hbm_proxy_bytes += 2.0 * sum(t.numel() * t.element_size()
                                           for t in outs)
            for t in outs:
                self._allocated(t)
            return out
        if name in _DOT_OPS:
            c.dot_flops += _dot_flops(name, args, out)
        elif name in ("convolution", "convolution_backward"):
            c.dot_flops += _conv_flops(name, args, out)
        outs = list(_tensors(out))
        if name in _MATERIALIZING_ATEN:
            c.hbm_proxy_bytes += 2.0 * sum(t.numel() * t.element_size()
                                           for t in outs)
        fresh = [r.alias_info is None for r in func._schema.returns]
        if len(fresh) != len(outs):  # one return that is a list
            fresh = fresh[:1] * len(outs)
        for t, new in zip(outs, fresh):
            if new:
                self._allocated(t)
        return out

    def launch(self, lib: str) -> None:
        """Called at every kernel launch (``kernels.build.load``): raise
        unless the launch is inside a kernel call counted by formula."""
        if not self._in_kernel:
            raise UncountedKernelError(
                f"a {lib} kernel launched under the cost counter, which has "
                f"no FLOP and byte formula for it (it counts "
                f"{', '.join(FORMULAS)})")

    def kernel(self, name: str, args: tuple,
               run: Callable[[], torch.Tensor]) -> torch.Tensor:
        """Count one call of kernel ``name`` by its formula,
        ``FORMULAS[name](*args)`` = (dot FLOPs, bytes), and run it
        (``run()``) with its own ops left uncounted; its output is a fresh
        allocation."""
        flops, nbytes = FORMULAS[name](*args)
        c = self.cost
        c.dot_flops += flops
        c.hbm_proxy_bytes += nbytes
        c.kernels[name] = c.kernels.get(name, 0) + 1
        self._in_kernel = True
        try:
            out = run()
        finally:
            self._in_kernel = False
        self._allocated(out)
        return out


def count(fn: Callable, *args, pod_size: int | None = None,
          **kwargs) -> tuple[object, LoopAwareCost]:
    """``(fn(*args, **kwargs), its cost)``."""
    with CostCounter(pod_size) as ctr:
        out = fn(*args, **kwargs)
    return out, ctr.cost
