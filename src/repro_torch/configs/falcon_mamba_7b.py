"""falcon-mamba-7b [arXiv:2410.05355]: attention-free Mamba-1, 64L
d_model=4096 (d_inner=8192, ssm_state=16, d_conv=4, dt_rank=256)
vocab=65024. Decode state is O(1) in sequence length => RUNS long_500k
(and is the natural best case for the residency/occupancy analogue)."""
from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    d_conv=4,
    expand=2,
    dt_rank=256,
    compression=HIGH_QUALITY_COMPRESSION,
)
