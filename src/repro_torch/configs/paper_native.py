"""The paper's own evaluation vehicle: not an LM but the 11-kernel
GPU suite (Table 4) driven through the static framework at the
register-file granularity. This config names the suite for the benchmark
harness; see repro.core.compress and benchmarks/fig9_pressure.py."""
from repro_torch.models.config import ModelConfig, NO_COMPRESSION

# A minimal dense stand-in so `--arch paper_native` still lowers a model;
# the real paper-native experiments live in the GPU-granularity suite.
CONFIG = ModelConfig(
    name="paper-native",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    head_dim=64,
    compression=NO_COMPRESSION,
)
