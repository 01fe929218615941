"""granite-34b [arXiv:2405.04324]: 88L d_model=6144 48H (MQA kv=1)
d_ff=24576 vocab=49152 — llama-style attention with MQA, non-gated GELU
MLP (GPTBigCode lineage keeps the 2-matrix FFN at this d_ff to land on
34B params). Pure full attention => long_500k skipped. Speculative
serving drafts at AF12."""
import dataclasses

from repro_torch.models.config import HIGH_QUALITY_COMPRESSION, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    gated_mlp=False,
    rope_theta=10000.0,
    compression=dataclasses.replace(
        HIGH_QUALITY_COMPRESSION, draft_weight_bits=12),
)
