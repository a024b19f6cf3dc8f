"""Config registry: --arch <id> resolution for the archs the port runs, and
the four assigned input shapes of the dry-run matrix.

The reference knows ten archs, and the port builds all ten.  An arch in
``PENDING`` (none now) would raise a ``KeyError`` that names the ROADMAP
item that ports it.
"""
from __future__ import annotations

import dataclasses
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

PORTED = ("granite_3_8b", "zamba2_1_2b", "xlstm_1_3b", "h2o_danube_3_4b", "minitron_4b",
          "gemma3_4b", "granite_moe_3b_a800m", "deepseek_v2_lite_16b", "whisper_base",
          "qwen2_vl_7b")

# ROADMAP.md queue 1 item that brings each not-yet-ported arch over
PENDING: dict = {}

ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


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


def runnable(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """Is (arch, shape) in the dry-run matrix?  DESIGN.md §long_500k."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: no sub-quadratic/bounded-cache "
                       "decode mode (DESIGN.md skip)")
    return True, ""
