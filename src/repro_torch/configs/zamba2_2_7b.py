"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

The port's copy of the reference's config, field for field.  54 Mamba2
layers; every 6th is followed by one of 2 weight-shared transformer blocks
(round-robin), which reads ``concat(h, x0)`` (2 d_model wide) and writes
d_model: 9 applications, each with its own KV ring.  Its attention heads
(G 1, D 80) are a flash-decode instance of their own.
"""

from repro_torch.configs.base import (FedTimeConfig, HybridConfig,
                                      ModelConfig, SSMConfig)

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,                      # mamba2 layers
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10_240,                        # shared block FFN
    vocab_size=32_000,
    activation="geglu",
    ssm=SSMConfig(
        state_dim=64,                   # ssm_state=64 per assignment
        head_dim=64,
        expand=2,
        conv_width=4,
        chunk_size=128,
    ),
    hybrid=HybridConfig(
        shared_attn_every=6,            # 54/6 = 9 shared-block applications
        num_shared_blocks=2,            # Zamba2 round-robins 2 shared blocks
    ),
    fedtime=FedTimeConfig(),
    source="arXiv:2411.15242 (Zamba2)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-2.7b-smoke",
        num_layers=4,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, chunk_size=32),
        hybrid=HybridConfig(shared_attn_every=2, num_shared_blocks=2),
        param_dtype="float32",
        compute_dtype="float32",
    )
