"""gemma2-27b — dense, local+global alternating attention, logit softcap.
[arXiv:2408.00118]

The port's copy of the reference's config, field for field.
"""

from repro_torch.configs.base import ModelConfig, FedTimeConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,                       # gemma2-27b model card
    d_ff=36_864,
    vocab_size=256_000,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,                # local layers' window
    local_global_alternating=True,
    rope_theta=10_000.0,
    activation="geglu",
    tie_embeddings=True,
    embedding_multiplier=67.88225099390856,   # sqrt(4608)
    post_block_norm=True,
    fedtime=FedTimeConfig(),
    source="arXiv:2408.00118 (Gemma 2)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-27b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        sliding_window=64,
        embedding_multiplier=16.0,
        param_dtype="float32",
        compute_dtype="float32",
    )
