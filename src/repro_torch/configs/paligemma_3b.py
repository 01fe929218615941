"""paligemma-3b [arXiv:2407.07726]: SigLIP vision tower (STUB:
input_specs() provides 256 precomputed patch embeddings) + gemma decoder
18L d_model=2048 8H (MQA kv=1, head_dim 256) d_ff=16384 vocab=257216.
Image prefix attends bidirectionally; text is causal. long_500k skipped
(full attention)."""
from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    num_image_tokens=256,
    tie_embeddings=True,
    compression=HIGH_QUALITY_COMPRESSION,
)
