"""Model configuration for the PyTorch port.

The port's own copy of the JAX package's ``ModelConfig`` (same fields, same
defaults), so that a config means the same model in both packages.  Each
architecture gets one module in ``repro_torch.configs`` exporting
``CONFIG`` (the exact published dims) and ``smoke_config()`` (a reduced
variant for CPU tests).  The family sub-configs are kept because
``ModelConfig`` names them; the dense and MoE families are ported.
``INPUT_SHAPES`` are the reference's four input shapes of the dry run
(``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (GShard-style dispatch)."""

    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0          # Qwen2-MoE style always-on experts
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # d_ff of each routed expert (may differ from the dense d_ff)
    expert_d_ff: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    state_dim: int = 64                  # N — per-head SSM state size
    head_dim: int = 64                   # P — channels per SSM head
    expand: int = 2                      # d_inner = expand * d_model
    conv_width: int = 4                  # depthwise causal conv width
    chunk_size: int = 128                # chunked-scan block length


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block configuration (mLSTM + sLSTM mix)."""

    slstm_every: int = 6                 # every k-th block is sLSTM (rest mLSTM)
    mlstm_proj_factor: float = 2.0       # up-projection factor for mLSTM blocks
    slstm_proj_factor: float = 1.333     # FFN factor for sLSTM blocks
    conv_width: int = 4
    chunk_size: int = 128


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + shared attention block."""

    shared_attn_every: int = 6           # apply the (weight-shared) attn block
                                         # every k mamba layers
    num_shared_blocks: int = 2           # distinct shared transformer blocks
                                         # (Zamba2 uses 2, round-robin)


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder split (seamless-m4t style backbone)."""

    encoder_layers: int = 12
    # decoder layer count == ModelConfig.num_layers
    encoder_bidirectional: bool = True
    max_source_len: int = 4096           # frame-embedding memory length cap


@dataclass(frozen=True)
class VLMConfig:
    """VLM backbone (paligemma style): prefix-LM over stub patch embeddings."""

    num_image_tokens: int = 256          # SigLIP 224px/14 => 256 patches
    vision_embed_dim: int = 1152         # SigLIP-So400m width (stub output)
    prefix_lm: bool = True               # bidirectional attention over prefix


@dataclass(frozen=True)
class FedTimeConfig:
    """The paper's TS front-end (C1) + federation hyper-params (C3/C5)."""

    # --- PatchTST-style front end ---
    lookback: int = 512                  # L
    horizon: int = 96                    # T
    patch_len: int = 16                  # P
    patch_stride: int = 8                # S (overlapping patches)
    revin: bool = True                   # RevIN in forecasting-FT phase
    # --- federation ---
    num_clients: int = 555               # paper's setup
    num_clusters: int = 8                # K in K-means
    clients_per_round: int = 16
    local_steps: int = 40                # paper grid: {40, 80, 200}
    # --- PEFT ---
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    qlora: bool = True                   # NF4-quantize frozen base weights
    qlora_block: int = 64                # absmax block size (NF4 default)
    # --- DPO alignment ---
    dpo_beta: float = 0.1
    dpo_pairs: int = 10_000              # paper: 10K comparison pairs


@dataclass(frozen=True)
class ModelConfig:
    """One config to describe every supported architecture."""

    name: str
    family: str                          # dense | moe | encdec | vlm | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 => d_model // num_heads
    # --- attention variants ---
    qk_norm: bool = False                # Qwen3-style per-head RMSNorm on q,k
    attn_logit_softcap: float = 0.0      # Gemma2 (50.0); 0 disables
    final_logit_softcap: float = 0.0     # Gemma2 (30.0); 0 disables
    sliding_window: int = 0              # 0 => full attention
    local_global_alternating: bool = False   # Gemma2 local/global layer pairs
    rope_theta: float = 10_000.0
    max_seq_len: int = 524_288
    # --- MLP ---
    activation: str = "swiglu"           # swiglu | geglu | gelu
    # --- norm / embedding ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embedding_multiplier: float = 1.0    # Gemma scales embeds by sqrt(d_model)
    post_block_norm: bool = False        # Gemma2 post-norms
    # --- family sub-configs ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    fedtime: Optional[FedTimeConfig] = None
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- provenance ---
    source: str = ""                     # citation (model card / arXiv)
    # --- decode-time overrides ---
    # For pure full-attention archs, long_500k decode runs under this
    # sliding-window variant (see DESIGN.md §4 long_500k policy).
    decode_sliding_window: int = 0

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim()

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim()

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.family not in ("dense", "moe", "encdec", "vlm", "ssm",
                               "hybrid"):
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        if self.family != "ssm" and \
                self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads={self.num_heads} not "
                             f"divisible by num_kv_heads={self.num_kv_heads}")
        needs = {"moe": "moe", "hybrid": "hybrid", "encdec": "encdec",
                 "vlm": "vlm"}
        sub = needs.get(self.family)
        if sub is not None and getattr(self, sub) is None:
            raise ValueError(f"{self.name}: family {self.family!r} needs "
                             f"the {sub!r} sub-config")


# ---------------------------------------------------------------------------
# The input shapes of the dry run (the reference's, field for field).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
