"""deepseek-moe-16b [arXiv:2401.06066]: 28L d_model=2048 16H (kv=16 = MHA)
fine-grained MoE: 64 routed experts (d_ff=1408 each) top-6 + 2 shared
experts. Routing indices are 6-bit integers under range analysis — the
narrow-int side of the paper's technique shows up in the router stream.
long_500k skipped (full attention)."""
from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    vocab_size=102400,
    head_dim=128,
    capacity_factor=1.25,
    compression=HIGH_QUALITY_COMPRESSION,
)
