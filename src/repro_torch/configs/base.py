"""Architecture config schema: the port's own copy of ``repro.configs.base``.

The fields are the reference's, unchanged, so that a config file can be
copied over as it is; only ``compute_dtype`` differs and returns a
``torch.dtype``.  Each ``src/repro_torch/configs/<id>.py`` instantiates the
full spec and a ``smoke()`` reduced variant for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    citation: str = ""

    # block pattern ----------------------------------------------------------
    # sequence of block kinds tiled over depth; e.g. gemma3 ("local",)*5+("global",)
    block_pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 4096       # window for "local"/SWA blocks
    mlp_act: str = "swiglu"          # swiglu | gelu | squared_relu
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True            # whisper: additive sinusoid instead
    scale_embed: bool = False        # gemma: x *= sqrt(d_model)
    norm_eps: float = 1e-6

    # MoE ----------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden (d_ff used for dense layers)
    first_layer_dense: bool = False  # deepseek: layer 0 is a dense MLP
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    expert_pad_to: int = 0           # pad expert count (dead, never-routed
                                     # experts) so E divides the mesh model
                                     # axis -> expert-parallel dispatch
                                     # (perf variant; function unchanged)

    # MLA (deepseek) -------------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # SSM / xLSTM / Mamba2 ---------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner_mult: int = 2            # d_inner = mult * d_model
    ssm_chunk: int = 256             # chunkwise-scan chunk length
    slstm_every: int = 0             # xlstm: every Nth layer is sLSTM
    shared_attn_every: int = 0       # zamba2: shared attention after every N ssm blocks

    # enc-dec (whisper) --------------------------------------------------------
    encoder_layers: int = 0
    encoder_len: int = 1500          # precomputed frame-embedding length (stub frontend)

    # VLM (qwen2-vl) -----------------------------------------------------------
    use_mrope: bool = False
    n_vision_tokens: int = 256       # precomputed patch embeddings per sample (stub)

    # numerics / runtime -------------------------------------------------------
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    use_kernels: bool = False        # dispatch to the hand-written CUDA / Triton kernels
    fused_attention: bool = False    # plain path: chunked online-softmax
                                     # attention (no S^2 materialisation)
    attn_chunk: int = 1024           # kv-chunk for fused attention
    sharding_profile: str = "tp"     # "tp" (model axis active) | "dp" (pure
                                     # data-parallel; batch spans model axis)
    remat: bool = False              # activation checkpointing for train_step
    scan_unroll: bool = False        # dry-run: unroll layer/chunk scans so
                                     # XLA cost analysis sees true totals
                                     # (while bodies are otherwise counted once)
    chunk_unroll: Optional[bool] = None  # override for time-chunk scans only
                                     # (None -> follow scan_unroll); the dry-run
                                     # keeps these rolled + analytically corrected
                                     # to bound compile time
    max_decode_len: int = 0          # kv-cache length for serve_step (set by shape)
    zero1: bool = False              # ZeRO-1: shard optimizer state over data axis

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic / bounded-cache decode available?  True for state
        recurrences (ssm/hybrid) and for archs with sliding-window layers
        (ring caches); full-attention kinds (global, mla) disqualify unless
        windowed layers bound the non-window cache count.  DESIGN.md
        §long_500k: gemma3's few global layers still fit at batch=1, so
        'local' presence wins there."""
        if self.family in ("ssm", "hybrid"):
            return True
        return "local" in self.block_pattern

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decode path (whisper is enc-dec)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- simple analytic param count for roofline MODEL_FLOPS = 6 N D ---------
    def approx_active_params(self) -> int:
        """Active (per-token) non-embedding params, for 6*N_active*D."""
        D, F, L = self.d_model, self.d_ff, self.n_layers
        hd, Hq, Hkv = self.head_dim, self.n_heads, self.n_kv_heads
        if self.use_mla:
            r = self.kv_lora_rank
            attn = D * Hq * (self.qk_nope_dim + self.qk_rope_dim) + D * (r + self.qk_rope_dim) \
                + r * Hq * (self.qk_nope_dim + self.v_head_dim) + Hq * self.v_head_dim * D
        else:
            attn = D * hd * (Hq + 2 * Hkv) + Hq * hd * D
        if self.family == "ssm":          # xlstm-style block, no separate FFN
            inner = self.d_inner
            per_layer = 2 * D * inner + inner * D  # in/out proj + gates (approx)
            return L * per_layer
        if self.n_experts:
            moe = 3 * D * self.moe_d_ff * (self.top_k + self.n_shared_experts)
            dense_l = 1 if self.first_layer_dense else 0
            return (L - dense_l) * (attn + moe) + dense_l * (attn + 3 * D * F)
        if self.family == "hybrid":
            inner = self.d_inner
            ssm_per = 2 * D * inner + inner * self.ssm_state
            n_attn = L // max(self.shared_attn_every, 1)
            return L * ssm_per + n_attn * (attn + 3 * D * F)
        mlp = (3 if self.mlp_act == "swiglu" else 2) * D * F
        enc = self.encoder_layers * (attn + mlp)
        return L * (attn + mlp) + enc
