"""The port stands alone: no jax, nothing of ``repro``, no CPU fallback."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _python(*args, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'ml_dtypes', "
            "'repro') or m.startswith(('jax.', 'ml_dtypes.', 'repro.'))]\n"
            "print('BAD', bad)\n")
    res = _python("-c", code)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout
    assert {"repro_torch.engine.dispatch", "repro_torch.kernels.stream",
            "repro_torch.kernels.components", "repro_torch.launch.access",
            "repro_torch.core.decomp", "repro_torch.core.halo",
            "repro_torch.dist", "repro_torch.dist.mesh",
            "repro_torch.dist.stencil",
            "repro_torch.engine.distributed", "repro_torch.backends",
            "repro_torch.backends.ir", "repro_torch.backends.lower",
            "repro_torch.backends.sim", "repro_torch.backends.report",
            "repro_torch.backends.__main__", "repro_torch.analysis.verify",
            "repro_torch.analysis.sweep",
            "repro_torch.analysis.__main__"} <= set(MODULES)


def test_source_has_no_jax_or_repro_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ml_dtypes|repro|benchmarks)"
                     r"(\.|\s|$)",
                     re.M)
    offenders = [str(p) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
                 if pat.search(p.read_text())]
    assert offenders == []


def test_cli_without_device_cpu_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI default runs on it")
    res = _python("-m", "repro_torch.launch.solve", "--ny", "14", "--nx",
                  "30", "--iters", "3")
    assert res.returncode != 0
    assert "cuda" in res.stderr and "CHECK OK" not in res.stdout


def test_cli_on_cpu_checks_against_reference():
    res = _python("-m", "repro_torch.launch.solve", "--ny", "30", "--nx",
                  "62", "--iters", "19", "--t", "4", "--device", "cpu",
                  "--check")
    assert res.returncode == 0, res.stderr
    assert "CHECK OK" in res.stdout
    assert "temporal: 19 sweeps = 4 x t=4 + 3 (rowchunk)" in res.stdout
    res = _python("-m", "repro_torch.launch.solve", "--ny", "30", "--nx",
                  "62", "--iters", "19", "--dtype", "bfloat16", "--tol",
                  "1e-3", "--device", "cpu", "--check")
    assert res.returncode == 0, res.stderr
    assert "iters=16/19" in res.stdout and "CHECK OK" in res.stdout


def test_kernel_build_is_deferred_to_first_launch():
    """Importing the build module needs no nvcc; building without it
    raises instead of falling back."""
    from repro_torch.kernels import build
    if build.shutil.which("nvcc") or os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build._nvcc()


def test_cli_sim_backend_and_verify_on_cpu():
    """``--backend sim`` runs the simulator, ``--verify`` prints the static
    report, and the refusals carry the reference's messages."""
    base = ["-m", "repro_torch.launch.solve", "--ny", "30", "--nx", "62",
            "--iters", "19", "--t", "4", "--device", "cpu"]
    res = _python(*base, "--kernel", "temporal", "--backend", "sim",
                  "--device-model", "grayskull_e150", "--verify", "--check")
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "verify: " in out and "program temporal grid=(32, 64)" in out
    assert "backend=sim device=grayskull_e150" in out
    assert "(MODELED)" in out and "CHECK OK" in out
    res = _python(*base, "--verify", "--check")
    assert res.returncode == 0, res.stderr
    assert "verify: " in res.stdout and "CHECK OK" in res.stdout
    res = _python(*base, "--backend", "sim", "--devices", "2")
    assert res.returncode != 0
    assert ("--backend sim models one chip's core grid; drop --devices "
            "(cores are simulated inside)") in res.stderr
    res = _python(*base, "--backend", "sim", "--serve")
    assert res.returncode != 0
    assert "--serve drives the single-device engine" in res.stderr
    res = _python("-m", "repro_torch.backends", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "BACKENDS SMOKE OK" in res.stdout
