"""Config registry: --arch <id> resolution for the archs the port runs.

The reference knows ten archs.  The port resolves the same names but only
builds the ones it has ported; the others raise a ``KeyError`` that names
the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

ARCH_IDS = (
    "granite_moe_3b_a800m",
    "xlstm_1_3b",
    "granite_3_8b",
    "gemma3_4b",
    "deepseek_v2_lite_16b",
    "h2o_danube_3_4b",
    "whisper_base",
    "minitron_4b",
    "qwen2_vl_7b",
    "zamba2_1_2b",
)

PORTED = ("granite_3_8b", "zamba2_1_2b", "xlstm_1_3b", "h2o_danube_3_4b", "minitron_4b")

# ROADMAP.md queue 1 item that brings each not-yet-ported arch over
PENDING = {
    "gemma3_4b": "1.2 (head dim 320: wider attention tiles; tied head, `scale_embed`)",
    "granite_moe_3b_a800m": "1.6 (MoE)",
    "deepseek_v2_lite_16b": "1.7 (MLA)",
    "whisper_base": "1.9 (enc-dec)",
    "qwen2_vl_7b": "1.9 (VLM)",
}

ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _normalize(arch: str) -> str:
    """Accept module names, --arch ids, and display names (dots/dashes)."""
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    if name not in PORTED:
        raise KeyError(f"arch {name!r} is not ported to PyTorch yet: "
                       f"ROADMAP.md queue 1 item {PENDING[name]}; "
                       f"ported: {list(PORTED)}")
    return name


def get_config(arch: str) -> ArchConfig:
    return importlib.import_module(f"repro_torch.configs.{_normalize(arch)}").config()


def get_smoke_config(arch: str) -> ArchConfig:
    return importlib.import_module(f"repro_torch.configs.{_normalize(arch)}").smoke()


def list_archs():
    return list(PORTED)
