"""qwen3-0.6b — dense decoder, qk-norm, GQA. [hf:Qwen/Qwen3-8B family card]"""

from repro_torch.configs.base import FedTimeConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,                       # Qwen3 uses explicit head_dim=128
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
    tie_embeddings=True,
    decode_sliding_window=4096,
    fedtime=FedTimeConfig(),
    source="hf:Qwen/Qwen3-8B (0.6B sibling card)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-0.6b-smoke",
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
