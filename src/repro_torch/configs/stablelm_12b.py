"""stablelm-12b [hf:stabilityai]: 40L d_model=5120 32H (GQA kv=8)
d_ff=13824 vocab=100352 — RoPE + SwiGLU. head_dim = 5120/32 = 160.
Pure full attention => long_500k skipped. Speculative serving drafts at
AF8 (two ladder steps down: this arch tolerates the narrowest draft)."""
import dataclasses

from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,
    gated_mlp=True,
    rope_theta=10000.0,
    compression=dataclasses.replace(
        HIGH_QUALITY_COMPRESSION, draft_weight_bits=8),
)
