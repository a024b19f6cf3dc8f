"""zamba2-1.2b [hybrid] -- 38L d2048 32H(kv32) ff8192 v32000 ssm_state=64;
Mamba2 backbone + weight-tied shared attention+MLP block applied every 6
mamba layers [arXiv:2411.15242].  long_500k adaptation: the shared block is
windowed at sliding_window for >64k decode budgets (DESIGN.md deviation)."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid", citation="arXiv:2411.15242",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=32000, ssm_state=64, shared_attn_every=6,
        d_inner_mult=2, sliding_window=4096, ssm_chunk=256,
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=0,
        vocab_size=512, d_ff=256, ssm_state=16, shared_attn_every=2,
        ssm_chunk=16, sliding_window=16, dtype="float32")
