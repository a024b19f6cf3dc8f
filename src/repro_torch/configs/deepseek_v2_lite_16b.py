"""deepseek-v2-lite-16b [moe] -- 27L d2048 16H(kv16) expert-ff1408 v102400;
MLA (kv_lora 512, decoupled rope 64/nope 128/v 128), 64 routed experts top-6
+ 2 shared, first layer dense [arXiv:2405.04434.  Assignment header says
"64e top-6"; its bracket note "160 routed" describes full V2 -- we build the
actual Lite config per the header, recorded in DESIGN.md]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b", family="moe", citation="arXiv:2405.04434",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
        vocab_size=102400, block_pattern=("mla",),
        n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
        first_layer_dense=True,
        use_mla=True, kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
        v_head_dim=128,
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=0,
        vocab_size=512, d_ff=256, n_experts=4, top_k=2, n_shared_experts=1,
        moe_d_ff=64, kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32,
        v_head_dim=32, dtype="float32")
