"""qwen2-moe-a2.7b — MoE decoder, 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

The port's copy of the reference's config, field for field.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, FedTimeConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                          # routed expert intermediate size
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    activation="swiglu",
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        num_shared_experts=4,
        expert_d_ff=1408,
        capacity_factor=1.25,
    ),
    decode_sliding_window=4096,
    fedtime=FedTimeConfig(),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-moe-a2.7b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      expert_d_ff=128, capacity_factor=1.5),
        param_dtype="float32",
        compute_dtype="float32",
    )
