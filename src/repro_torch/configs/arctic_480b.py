"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d_model=7168 56H
(GQA kv=8), 128 experts top-2 (d_ff=4864 each) + a dense residual MLP
(d_ff=4864) in parallel. The largest assigned state => largest packing
win. long_500k skipped (full attention)."""
from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    moe_d_ff=4864,
    n_experts=128,
    n_shared_experts=0,
    experts_per_token=2,
    dense_residual=True,
    vocab_size=32000,
    head_dim=128,
    capacity_factor=1.25,
    compression=HIGH_QUALITY_COMPRESSION,
)
