"""qwen3-8b [hf:Qwen/Qwen3-8B]: 36L d_model=4096 32H (GQA kv=8)
d_ff=12288 vocab=151936 — qk_norm on per-head q/k, SwiGLU, GQA.
Pure full attention => long_500k skipped. Speculative serving drafts at
AF12 (one ladder step below the AF16 weight plan)."""
import dataclasses

from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    gated_mlp=True,
    qk_norm=True,
    rope_theta=1000000.0,
    compression=dataclasses.replace(
        HIGH_QUALITY_COMPRESSION, draft_weight_bits=12),
)
