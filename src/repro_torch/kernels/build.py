"""Build the CUDA kernels at first use and load them with ctypes.

Each source under ``repro_torch/csrc`` is compiled by ``nvcc`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build dir>/lib<name>-<hash>.so <name>.cu

``stencil.cu`` alone adds ``-ftz=true`` (:data:`SOURCE_FLAGS`): its f32
arithmetic flushes subnormals, as XLA's does, so K1–K4 equal the JAX
stencil path on a diffusion front's subnormal tail. The library name
carries a hash of the source and its flags, so an edited source is
rebuilt and a stale library is never loaded. The build directory is
``repro_torch/_build`` (listed in ``.gitignore``); ``REPRO_TORCH_BUILD_DIR``
moves it. Nothing here runs at import: the CPU tests import every module
of the port, and a machine without ``nvcc`` only fails when a kernel is
actually launched. :func:`build_all` starts one ``nvcc`` per source, all
at once.

Every launch runs inside :func:`on_card`: a ``<<<...>>>`` launch, the
``cudaFuncSetAttribute`` a launcher sets before it and the SM count a
launcher reads all act on the CUDA runtime's *current* device, so the
operands' card is made current around the call, whichever card the
caller had current.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("stencil", "flash_attention", "flash_attention_sm90", "conv1d",
           "stream")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: Flags one source adds to :data:`NVCC_FLAGS`.
SOURCE_FLAGS = {"stencil": ("-ftz=true",)}

_LIBS: dict[str, ctypes.CDLL] = {}

#: Launch observers, innermost last: ``hlo_analysis.CostCounter`` adds
#: itself while it runs. A wrapper with a cost formula (K8, K7) hands its
#: call to the innermost one, ``observer().kernel(name, args, run)``;
#: every launch asks :func:`load` for its library, which first calls
#: ``observer().launch(name)``, so an observer sees every launch.
OBSERVERS: list = []


def observer():
    """The innermost launch observer, or None."""
    return OBSERVERS[-1] if OBSERVERS else None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def launch_device(*operands) -> torch.device:
    """The one device a launch's ``operands`` (tensors, or None for an
    operand left out) sit on; operands on two devices raise."""
    devs = {t.device for t in operands if t is not None}
    if len(devs) != 1:
        raise ValueError(f"a kernel's operands must sit on one card; got "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


@contextlib.contextmanager
def on_card(*operands):
    """Make the operands' card current around a launch; yield the handle
    of that card's current stream, which the launchers take.

    Enter it only around the ctypes call (and what the launcher reads of
    the card): the previous current device is restored on exit."""
    dev = launch_device(*operands)
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "REPRO_TORCH_BUILD_DIR", CSRC.parent / "_build"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on first launch")


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The flags ``name``'s source is compiled with."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _target(name: str, csrc: pathlib.Path) -> pathlib.Path:
    src = csrc / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(nvcc_flags(name)).encode()
                            ).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str, csrc: pathlib.Path = CSRC
           ) -> tuple[pathlib.Path, subprocess.Popen | None]:
    """Start nvcc for ``name`` unless its library is already built."""
    out = _target(name, csrc)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(csrc / f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: pathlib.Path,
            proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = pathlib.Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    tmp.replace(out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, pathlib.Path]:
    """Build every source in parallel (one nvcc each); return the libraries."""
    started = {name: _start(name) for name in SOURCES}
    for name, (out, proc) in started.items():
        _finish(name, out, proc)
    return {name: out for name, (out, _) in started.items()}


def load(name: str = "stencil", csrc: pathlib.Path = CSRC) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed. ``csrc`` is
    the source directory: another checkout's, to compare two versions of a
    kernel (its library is named by its own source's hash). Every launch
    asks for its library here; the innermost observer is told first."""
    obs = observer()
    if obs is not None:
        obs.launch(name)
    key = name if csrc == CSRC else f"{name}@{csrc}"
    lib = _LIBS.get(key)
    if lib is None:
        out, proc = _start(name, csrc)
        _finish(name, out, proc)
        lib = _LIBS[key] = _bind(name, ctypes.CDLL(str(out)))
    return lib


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
IP = ctypes.POINTER(ctypes.c_int)
F32 = ctypes.c_float

#: argtypes of each launcher (pointers and the stream as c_void_p).
SIGNATURES = {
    "stencil": {
        "repro_rowchunk": [P, P, *[I] * 12, IP, IP, F, I, P],
        "repro_dbuf": [P, P, *[I] * 13, IP, IP, F, I, P],
        "repro_temporal": [P, P, P, *[I] * 12, IP, IP, F, I, P],
        "repro_temporal_chain": [P, P, P, *[I] * 13, IP, IP, F, I, P],
        "repro_shifted": [ctypes.POINTER(P), P, I, I, I, I, I, I, I, I, F,
                          P],
    },
    "flash_attention": {
        "repro_flash_attention": [P, P, P, P, I, I, I, I, I, I, I, F32, P],
    },
    "flash_attention_sm90": {
        "repro_flash_attention_sm90": [P, P, P, P, I, I, I, I, I, I, I, F32,
                                       P],
    },
    "conv1d": {
        "repro_conv1d": [P, P, P, P, I, I, I, I, I, I, I, P],
    },
    "stream": {
        "repro_stream_copy": [P, P, I, I, I, I, I, I, I, P],
        "repro_stream_rowdma": [P, P, I, I, I, I, I, I, I, P],
        "repro_stream_replicated": [P, P, I, I, I, I, I, P],
        "repro_dma_only": [P, P, I, I, I, I, P],
        "repro_compute_only": [P, P, I, I, I, I, P],
        "repro_l2_probe": [P, P, I, I, I, P],
    },
}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
