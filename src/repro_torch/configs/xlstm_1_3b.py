"""xlstm-1.3b [ssm] -- 48L d2048 4H(kv4) no-FFN v50304; sLSTM + mLSTM blocks
(every 8th layer sLSTM) [arXiv:2405.04517]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b", family="ssm", citation="arXiv:2405.04517",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50304, slstm_every=8, ssm_chunk=256,
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=0,
        vocab_size=512, slstm_every=2, ssm_chunk=16, dtype="float32")
