"""The frozen reference against the port's plain path at a small size,
and the reference's independence from the program."""
import subprocess
import sys

import pytest
import torch

from bench import harness
from bench.inputs import TIMED, make_grid
from bench.reference import jacobi as ref

FIVE = dict(offsets=[[-1, 0], [1, 0], [0, -1], [0, 1]], weights=[0.25] * 4)
NINE = dict(offsets=[[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 1], [1, -1],
                     [1, 0], [1, 1]],
            weights=[0.05, 0.2, 0.05, 0.2, 0.2, 0.05, 0.2, 0.05])


def _cfg(dtype, st=FIVE, ny=12, nx=20):
    return {"ny": ny, "nx": nx, "dtype": dtype, "stencil": st,
            "ring": {"left": 1.0, "right": 0.0, "top": 0.0, "bottom": 0.0}}


def _spec(st):
    from repro_torch.core.stencil import StencilSpec
    return StencilSpec(offsets=tuple(map(tuple, st["offsets"])),
                       weights=tuple(st["weights"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("st", [FIVE, NINE], ids=["jacobi5", "laplace9"])
def test_sweep_and_residual_equal_the_ports_oracle(dtype, st):
    from repro_torch.core import stencil as S
    u = make_grid(_cfg(dtype, st), 3, TIMED, 0, torch.device("cpu"))
    spec = _spec(st)
    for _ in range(5):
        v = ref.sweep(u, st["offsets"], st["weights"])
        assert torch.equal(v, S.apply_stencil(u, spec))
        assert torch.equal(ref.residual(u, st["offsets"], st["weights"]),
                           S.residual(u, spec))
        u = v


def test_subnormals_flush_as_the_port_flushes():
    from repro_torch.core import stencil as S
    u = torch.zeros(6, 7)
    u[:, 0] = 1e-37
    u[2, 3] = 3e-38
    for _ in range(3):
        v = ref.sweep(u, FIVE["offsets"], FIVE["weights"])
        assert torch.equal(v, S.apply_stencil(u, _spec(FIVE)))
        u = v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixed_solves_equal_the_ports_plain_path(dtype):
    """Two fused blocks of 8 and 3 single sweeps, as ``auto`` runs 19."""
    from repro_torch import engine
    u = make_grid(_cfg(dtype), 4, TIMED, 1, torch.device("cpu"))
    got = engine.run(u, _spec(FIVE), policy="auto", iters=19)
    want = ref.run(u, FIVE["offsets"], FIVE["weights"], 19, store_every=8)
    assert torch.equal(want, got)
    if dtype == "bfloat16":
        # Stored every sweep, a bf16 grid rounds to another answer.
        every = ref.run(u, FIVE["offsets"], FIVE["weights"], 19)
        assert not torch.equal(every, got)


def test_converged_solves_equal_the_ports():
    from repro_torch import engine
    u = make_grid(_cfg("float32"), 5, TIMED, 2, torch.device("cpu"))
    curve = [float(ref.residual(ref.run(u, FIVE["offsets"], FIVE["weights"],
                                        8 * b), FIVE["offsets"],
                                FIVE["weights"])) for b in range(1, 9)]
    tol = (curve[3] + curve[2]) / 2
    want, iters, res, conv = ref.run_converged(
        u, FIVE["offsets"], FIVE["weights"], tol=tol, max_iters=64, t=8)
    got, g_iters, g_res = engine.run_converged(u, _spec(FIVE), tol=tol,
                                               max_iters=64, t=8)
    assert (iters, conv) == (32, True)
    assert g_iters == iters and g_res == res and torch.equal(got, want)
    _, iters, _, conv = ref.run_converged(u, FIVE["offsets"],
                                          FIVE["weights"], tol=None,
                                          max_iters=64, t=8)
    assert (iters, conv) == (64, False)


def test_the_control_departs_from_the_reference():
    u = make_grid(_cfg("float32"), 6, TIMED, 0, torch.device("cpu"))
    a = ref.run(u, FIVE["offsets"], FIVE["weights"], 10)
    b = ref.run(u, FIVE["offsets"], FIVE["weights"], 10,
                arith=torch.bfloat16)
    assert float((a - b).abs().max()) > 1e-4


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import bench.reference.jacobi, bench.checks; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'repro_torch', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(harness.ROOT))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert got.returncode == 0, got.stdout + got.stderr
