"""smollm-360m — llama-arch small dense decoder.
[hf:HuggingFaceTB/SmolLM-135M card family]

The port's copy of the reference's config, field for field; the training
launcher's default arch.  Its 15/5 heads of 64 decode through the
flash-decode instances at (G, D) = (3, 64).
"""

from repro_torch.configs.base import FedTimeConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,                        # 960 / 15
    d_ff=2560,
    vocab_size=49_152,
    rope_theta=10_000.0,
    activation="swiglu",
    tie_embeddings=True,
    decode_sliding_window=4096,
    fedtime=FedTimeConfig(),
    source="hf:HuggingFaceTB/SmolLM-360M",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="smollm-360m-smoke",
        num_layers=2,
        d_model=192,
        num_heads=3,
        num_kv_heads=1,
        head_dim=64,
        d_ff=384,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
    )
