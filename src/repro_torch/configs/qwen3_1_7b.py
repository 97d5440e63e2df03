"""qwen3-1.7b — dense decoder, qk-norm, GQA. [hf:Qwen/Qwen3-8B family card]

The port's copy of the reference's config, field for field.
"""

from repro_torch.configs.base import ModelConfig, FedTimeConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
    tie_embeddings=True,
    decode_sliding_window=4096,
    fedtime=FedTimeConfig(),
    source="hf:Qwen/Qwen3-8B (1.7B sibling card)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-1.7b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
    )
