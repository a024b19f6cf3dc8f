"""granite-3-8b [dense] -- 40L d4096 32H(kv8) ff12800 v49155, GQA
[hf:ibm-granite/granite-3.0-8b-base; assignment bracket cites the 2b card]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b", family="dense", citation="hf:ibm-granite/granite-3.0-8b-base",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
        vocab_size=49155, block_pattern=("global",),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=0,
        vocab_size=512, d_ff=256, dtype="float32")
