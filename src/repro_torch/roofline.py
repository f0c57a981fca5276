"""Three-term roofline from the cost counter (twin of ``repro.roofline``).

Hardware constants come from the device-model registry
(:mod:`repro_torch.engine.device`): ``hw=`` takes a registry name, a
:class:`DeviceModel` or a raw dict (default: ``tpu_v5e``, the
reference's). Terms, per device:

  compute    = dot FLOPs per device / peak_flops
  memory     = HBM-proxy bytes per device / hbm_bw
  collective = (collective - cross-pod bytes) / ici_bw
               + cross-pod bytes / dci_bw

The reference reads per-device quantities off XLA's SPMD module, whose
shapes are per partition. The port's partitioned count (``launch.
dryrun``: the program on DTensors over the production mesh, counted on
rank 0's local shapes) is per device likewise, collectives included, and
is read as counted. An unpartitioned count (``partitioned=False``: one
card's program, as ``chip_smoke.py``'s roofline cells count it) has no
collectives: its collective term is ``None`` with its reason
(``collective_reason``), never a made-up number, and its other terms
are the count over ``n_devices``. ``dominant`` and ``bound_s`` are
taken over the terms that exist.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.engine.device import DeviceModel, get_device
from repro_torch.hlo_analysis import LoopAwareCost

#: Legacy alias: the v5e constants, from the device registry.
V5E = get_device("tpu_v5e").as_roofline_hw()

NO_COLLECTIVES = "an unpartitioned count: one card's program"


def resolve_hw(hw: dict | str | DeviceModel | None) -> dict:
    """Normalize ``hw`` to the constants dict ``analyze`` consumes."""
    if hw is None:
        return V5E
    if isinstance(hw, dict):
        return hw
    return get_device(hw).as_roofline_hw()


@dataclasses.dataclass
class Roofline:
    flops: float               # whole-program dot flops
    hbm_bytes: float           # whole-program HBM-proxy bytes
    coll_bytes: Optional[int]  # per-device collective bytes
    cross_pod_bytes: Optional[int]
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0  # model_flops / counted flops
    bound_s: float = 0.0       # max of the terms that exist
    collective_reason: Optional[str] = None  # why collective_s is None

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(cost: LoopAwareCost, n_devices: int, model_flops: float = 0.0,
            pod_size: int | None = None,
            hw: dict | str | DeviceModel | None = None,
            partitioned: bool = True) -> Roofline:
    """The roofline of a counted program (``hlo_analysis``) on
    ``n_devices``: per device as counted when ``partitioned``, as the
    reference's ``analyze``; else the count over ``n_devices`` with no
    collective term (see the module note). ``pod_size`` prices the
    cross-pod bytes at ``dci_bw``."""
    hw = resolve_hw(hw)
    split = 1 if partitioned else n_devices
    flops_dev = cost.dot_flops / split
    hbm_dev = cost.hbm_proxy_bytes / split
    compute_s = flops_dev / hw["peak_flops"]
    memory_s = hbm_dev / hw["hbm_bw"]
    terms = {"compute": compute_s, "memory": memory_s}
    coll = cross = collective_s = None
    if partitioned:
        coll, cross = int(cost.collective_bytes), int(cost.cross_pod_bytes)
        collective_s = (cost.collective_bytes - cost.cross_pod_bytes) \
            / hw["ici_bw"]
        if pod_size and cost.cross_pod_bytes:
            collective_s += cost.cross_pod_bytes / hw["dci_bw"]
        terms["collective"] = collective_s
    dominant = max(terms, key=terms.get)
    total_flops = flops_dev * n_devices
    return Roofline(
        flops=total_flops, hbm_bytes=hbm_dev * n_devices,
        coll_bytes=coll, cross_pod_bytes=cross, n_devices=n_devices,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / total_flops if total_flops else 0.0),
        bound_s=max(terms.values()),
        collective_reason=None if partitioned else NO_COLLECTIVES)


def memory_per_device(argument_bytes: int, output_bytes: int,
                      alias_bytes: int, temp_bytes: int) -> dict:
    """Bytes per device, the reference's fields, all of one rank's local
    tensors: ``argument_bytes`` (the state, cache and batch as laid
    out), ``output_bytes`` and ``alias_bytes`` (outputs that are
    arguments written in place: the donated state), and the temporaries
    (the counter's peak of live storages less the fresh outputs)."""
    out = {"argument_size_in_bytes": int(argument_bytes),
           "output_size_in_bytes": int(output_bytes),
           "temp_size_in_bytes": int(temp_bytes),
           "alias_size_in_bytes": int(alias_bytes)}
    out["total_nonalias"] = (out["argument_size_in_bytes"]
                             + out["output_size_in_bytes"]
                             + out["temp_size_in_bytes"]
                             - out["alias_size_in_bytes"])
    return out


def model_flops_train(n_params_active: int, tokens: int) -> float:
    return 6.0 * n_params_active * tokens


def model_flops_infer(n_params_active: int, tokens: int) -> float:
    return 2.0 * n_params_active * tokens
