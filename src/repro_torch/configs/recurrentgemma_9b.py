"""recurrentgemma-9b [arXiv:2402.19427]: 38L d_model=4096 16H (MQA kv=1,
head_dim 256) d_ff=12288, RG-LRU + local attention at 2:1 (pattern
R,R,A x 12 groups + 2 tail recurrent layers = 38), window 2048.
Sub-quadratic => RUNS long_500k."""
from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    pattern_rec=2,
    pattern_attn=1,
    attn_window=2048,
    lru_width=4096,
    tie_embeddings=True,
    compression=HIGH_QUALITY_COMPRESSION,
)
