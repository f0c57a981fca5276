"""``python -m repro_torch.backends`` — the backends CI smoke.

Dispatches to :func:`repro_torch.backends.sim._smoke` (on the card; pass
``--device cpu`` for the CPU) without re-executing the
``sim`` module under a second name (``python -m repro_torch.backends.sim`` would
import it twice: once via the package ``__init__`` and once as
``__main__``, duplicating its exception classes). The guard keeps the
module import-safe for the package-tree import test.
"""
import argparse

from repro_torch.backends.sim import _smoke

if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m repro_torch.backends")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device the simulation runs on")
    raise SystemExit(_smoke(torch_device=ap.parse_args().device))
