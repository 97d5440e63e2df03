"""xlstm-350m — sLSTM + mLSTM recurrent blocks (attention-free).
[arXiv:2405.04517]

The port's copy of the reference's config, field for field.  d_ff=0: the
xLSTM blocks carry their own up/down projections (pre-up-projection mLSTM
blocks, post-FFN sLSTM blocks) instead of a transformer FFN.  No attention,
so no flash-decode instance; its state is O(1) in the sequence length.
"""

from repro_torch.configs.base import FedTimeConfig, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    activation="swiglu",
    xlstm=XLSTMConfig(
        slstm_every=6,                  # blocks 5, 11, 17, 23 are sLSTM
        mlstm_proj_factor=2.0,
        slstm_proj_factor=1.333,
        conv_width=4,
        chunk_size=128,
    ),
    fedtime=FedTimeConfig(),
    source="arXiv:2405.04517 (xLSTM, 350M)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-350m-smoke",
        num_layers=2,
        d_model=256,
        num_heads=2,
        num_kv_heads=2,
        head_dim=128,
        vocab_size=512,
        xlstm=XLSTMConfig(slstm_every=2, chunk_size=32),
        param_dtype="float32",
        compute_dtype="float32",
    )
