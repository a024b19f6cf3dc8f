"""whisper-base [audio] -- 6L enc + 6L dec, d512 8H(kv8) ff2048 v51865;
enc-dec with conv/mel frontend STUBBED (input_specs provides (B,1500,512)
frame embeddings) [arXiv:2212.04356].  Sinusoidal positions, GELU MLP.
Decoder design range is 448 tokens; decode_32k is lowered mechanically
(sharding proof), long_500k skipped (DESIGN.md)."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="audio", citation="arXiv:2212.04356",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab_size=51865, encoder_layers=6, encoder_len=1500,
        mlp_act="gelu", use_rope=False,
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=0,
        vocab_size=512, d_ff=128, encoder_layers=2, encoder_len=30,
        dtype="float32")
