"""granite-moe-3b-a800m [moe] -- 32L d1536 24H(kv8) expert-ff512 v49155,
40 experts top-8 [hf:ibm-granite/granite-3.0-3b-a800m-base; assignment sheet
header says 40e, bracket cites the 1b-a400m card (32e) -- we follow the 40e
header, discrepancy recorded in DESIGN.md]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m", family="moe", citation="hf:ibm-granite/granite-3.0-3b-a800m-base",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
        vocab_size=49155, n_experts=40, top_k=8, moe_d_ff=512,
        block_pattern=("global",),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, head_dim=0,
        vocab_size=512, n_experts=4, top_k=2, moe_d_ff=64, d_ff=64,
        dtype="float32")
