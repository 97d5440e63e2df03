"""fedtime-llama2-7b — the paper's own backbone: LLaMA-2-7B as the FedTime
LLM encoder.  [arXiv:2307.09288 (LLaMA-2 7B); paper §3.2 "LLM Encoder"]

The port's copy of the reference's config: same widths, same federation
and PEFT settings, same smoke variant.
"""

from repro_torch.configs.base import FedTimeConfig, ModelConfig

CONFIG = ModelConfig(
    name="fedtime-llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,                    # llama-2 7B uses MHA
    head_dim=128,
    d_ff=11_008,
    vocab_size=32_000,
    rope_theta=10_000.0,
    activation="swiglu",
    decode_sliding_window=4096,
    fedtime=FedTimeConfig(
        lookback=512,
        horizon=720,
        patch_len=16,
        patch_stride=8,
        num_clients=555,
        num_clusters=8,
        lora_rank=8,
        qlora=True,
    ),
    source="arXiv:2307.09288 (LLaMA-2 7B); paper §3.2",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="fedtime-llama2-7b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        fedtime=FedTimeConfig(
            lookback=96, horizon=24, patch_len=8, patch_stride=4,
            num_clients=8, num_clusters=2, clients_per_round=4,
            local_steps=2, lora_rank=4, dpo_pairs=16,
        ),
        param_dtype="float32",
        compute_dtype="float32",
    )
