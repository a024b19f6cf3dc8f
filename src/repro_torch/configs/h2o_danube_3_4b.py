"""h2o-danube-3-4b [dense] -- 24L d3840 32H(kv8) ff10240 v32000;
llama+mistral mix with sliding-window attention (window 4096)
[arXiv:2401.16818]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b", family="dense", citation="arXiv:2401.16818",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
        vocab_size=32000, block_pattern=("local",), sliding_window=4096,
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=0,
        vocab_size=512, d_ff=256, sliding_window=16, dtype="float32")
