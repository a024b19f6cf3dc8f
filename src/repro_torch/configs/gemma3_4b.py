"""gemma3-4b [dense] -- 34L d2560 8H(kv4) ff10240 v262144; 5:1 local:global
sliding-window pattern (window 1024), 128k context, tied embeddings
[hf:google/gemma-3-4b-pt; assignment bracket cites the 1b card]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-4b", family="dense", citation="hf:google/gemma-3-4b-pt",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
        vocab_size=262144,
        block_pattern=("local", "local", "local", "local", "local", "global"),
        sliding_window=1024, tie_embeddings=True, scale_embed=True,
        mlp_act="swiglu", rope_theta=1_000_000.0,
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=0,
        vocab_size=512, d_ff=256, sliding_window=16,
        block_pattern=("local", "global"), dtype="float32")
