"""seamless-m4t-medium — encoder-decoder multimodal (audio) backbone.
[arXiv:2308.11596]

The port's copy of the reference's config, field for field.  The audio
front end (mel spectrogram and conv feature extractor) is a stub, as in the
reference: the model takes precomputed frame embeddings of shape (batch,
frames, d_model).  12 bidirectional encoder layers over the frames and 12
decoder layers with self- and cross-attention over the text tokens; 16/16
heads of 64 (G 1, D 64: a flash-decode instance of its own), about 0.62 B
parameters with the tied 256,206-token embedding.
"""

from repro_torch.configs.base import EncDecConfig, FedTimeConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,                      # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    rope_theta=10_000.0,
    activation="gelu",                  # conformer-adjacent FFN; GELU per card
    tie_embeddings=True,                # shared embed/unembed (m4t text decoder)
    encdec=EncDecConfig(
        encoder_layers=12,
        encoder_bidirectional=True,
        max_source_len=4096,
    ),
    decode_sliding_window=4096,
    fedtime=FedTimeConfig(),
    source="arXiv:2308.11596 (SeamlessM4T, medium)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-m4t-medium-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        encdec=EncDecConfig(encoder_layers=2, max_source_len=128),
        param_dtype="float32",
        compute_dtype="float32",
    )
