"""Architecture registry: ``--arch <id>`` resolves here.

Only the archs whose model family the port runs are listed in
:data:`ARCHS`; the reference's other archs raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import importlib

ARCHS = {
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

#: The reference's archs that the port does not run yet, and why.
NOT_PORTED = {
    "hubert-xlarge": "the encoder family (models/encoder.py) and its "
                     "entry point",
    "qwen3-moe-30b-a3b": "the MoE family (layers/moe.py) and a way to hold "
                         "its 30.5 B parameters on one card",
    "qwen3-moe-235b-a22b": "the MoE family (layers/moe.py); at full width "
                           "it does not fit one card",
}


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} needs {NOT_PORTED[name]}, not ported yet "
            f"(ROADMAP Queue 1, D3); ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name])


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke()
