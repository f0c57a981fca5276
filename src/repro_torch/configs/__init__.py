"""Architecture registry: ``--arch <id>`` resolves here.

Only the archs whose model family the port runs are listed in
:data:`ARCHS`; the reference's other archs raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import importlib

ARCHS = {
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

#: The reference's archs that the port does not run yet, and why.
NOT_PORTED = {
    "internvl2-2b": "the VLM family",
    "minicpm3-4b": "MLA attention",
    "chatglm3-6b": "its config (dense, partial rotary) and a parity test",
    "hubert-xlarge": "the encoder family (models/encoder.py) and its "
                     "entry point",
    "qwen3-moe-30b-a3b": "the MoE family",
    "qwen3-moe-235b-a22b": "the MoE family",
}


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} needs {NOT_PORTED[name]}, not ported yet "
            f"(ROADMAP Queue 1); ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name])


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke()
