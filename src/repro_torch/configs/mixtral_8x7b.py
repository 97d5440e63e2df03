"""mixtral-8x7b — MoE decoder, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]

The port's copy of the reference's config, field for field.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, FedTimeConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    sliding_window=4096,                # SWA on every layer
    rope_theta=1_000_000.0,
    activation="swiglu",
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        num_shared_experts=0,
        expert_d_ff=14_336,
        capacity_factor=1.25,
    ),
    fedtime=FedTimeConfig(),
    source="arXiv:2401.04088 (Mixtral of Experts)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mixtral-8x7b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=256,
        vocab_size=512,
        sliding_window=64,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=0,
                      expert_d_ff=256, capacity_factor=1.5),
        param_dtype="float32",
        compute_dtype="float32",
    )
