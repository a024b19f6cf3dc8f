"""qwen2-vl-7b [vlm] -- 28L d3584 28H(kv4) ff18944 v152064; M-RoPE (t/h/w
position streams), dynamic-resolution ViT STUBBED (input_specs provides
precomputed patch embeddings + (B,3,S) position ids) [arXiv:2409.12191]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b", family="vlm", citation="arXiv:2409.12191",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
        vocab_size=152064, use_mrope=True, n_vision_tokens=256,
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=0,
        vocab_size=512, d_ff=256, n_vision_tokens=8, dtype="float32")
