"""phi3-medium-14b [arXiv:2404.14219]: 40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352 — RoPE, SwiGLU, GQA. Pure full attention =>
long_500k is skipped (see DESIGN.md section 6). Speculative serving
drafts at AF12."""
import dataclasses

from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    gated_mlp=True,
    rope_theta=10000.0,
    compression=dataclasses.replace(
        HIGH_QUALITY_COMPRESSION, draft_weight_bits=12),
)
