"""minitron-4b [dense] -- 32L d3072 24H(kv8) ff9216 v256000; pruned nemotron
(squared-ReLU MLP) [arXiv:2407.14679]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minitron-4b", family="dense", citation="arXiv:2407.14679",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
        vocab_size=256000, mlp_act="squared_relu",
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, head_dim=0,
        vocab_size=512, d_ff=256, dtype="float32")
