"""whisper-small [arXiv:2212.04356]: enc-dec audio backbone, 12L encoder +
12L decoder, d_model=768 12H (kv=12) d_ff=3072 vocab=51865. The conv
frontend is a STUB: input_specs() supplies precomputed (B, 1500, 768)
frame embeddings. Non-gated GELU MLPs. long_500k skipped (full attn)."""
from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    gated_mlp=False,
    compression=HIGH_QUALITY_COMPRESSION,
)
