"""Three-term roofline from the cost counter (twin of ``repro.roofline``).

Hardware constants come from the device-model registry
(:mod:`repro_torch.engine.device`): ``hw=`` takes a registry name, a
:class:`DeviceModel` or a raw dict (default: ``tpu_v5e``, the
reference's). Terms, per device:

  compute    = dot FLOPs per device / peak_flops
  memory     = HBM-proxy bytes per device / hbm_bw
  collective = None

The reference reads per-device quantities off XLA's SPMD module, whose
shapes are per partition. The port has no partitioner: the counter sees
the whole (global) program, and a term per device is the global count
divided by the devices, an even split. The collective term is ``None``
with its reason (``collective_reason``), never a made-up number: one
process has no collectives to count. ``dominant`` and ``bound_s`` are
taken over the terms that exist.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.engine.device import DeviceModel, get_device
from repro_torch.hlo_analysis import LoopAwareCost

#: Legacy alias: the v5e constants, from the device registry.
V5E = get_device("tpu_v5e").as_roofline_hw()

NO_COLLECTIVES = "no SPMD partitioner in one process"


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
    coll_bytes: Optional[int]  # per-device collective bytes: None here
    cross_pod_bytes: Optional[int]
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0  # model_flops / counted flops
    bound_s: float = 0.0       # max of the terms that exist
    collective_reason: str = NO_COLLECTIVES

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(cost: LoopAwareCost, n_devices: int, model_flops: float = 0.0,
            hw: dict | str | DeviceModel | None = None) -> Roofline:
    """The roofline of a counted program (``hlo_analysis``) run over
    ``n_devices`` (see the module note: an even split). The reference's
    ``pod_size`` only splits off cross-pod collective bytes, which one
    process does not have."""
    hw = resolve_hw(hw)
    compute_s = cost.dot_flops / n_devices / hw["peak_flops"]
    memory_s = cost.hbm_proxy_bytes / n_devices / hw["hbm_bw"]
    terms = {"compute": compute_s, "memory": memory_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        flops=cost.dot_flops, hbm_bytes=cost.hbm_proxy_bytes,
        coll_bytes=None, cross_pod_bytes=None, n_devices=n_devices,
        compute_s=compute_s, memory_s=memory_s, collective_s=None,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / cost.dot_flops
                      if cost.dot_flops else 0.0),
        bound_s=max(terms.values()))


def memory_per_device(argument_bytes: int, output_bytes: int,
                      alias_bytes: int, temp_bytes: int,
                      n_devices: int) -> dict:
    """Bytes per device, the reference's fields: ``argument_bytes`` per
    device, exact from the shardings of the state, cache and batch;
    ``output_bytes`` and ``alias_bytes`` (outputs that are arguments
    written in place: the donated state) per device likewise; the
    temporaries (the counter's peak of live storages less the fresh
    outputs) split evenly over the devices."""
    out = {"argument_size_in_bytes": int(argument_bytes),
           "output_size_in_bytes": int(output_bytes),
           "temp_size_in_bytes": int(temp_bytes // n_devices),
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
