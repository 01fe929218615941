"""Serving: the plain ``ServeEngine`` (greedy or sampled, dense or paged
KV) and the narrow-draft ``SpeculativeEngine``."""
from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serving.speculative import (  # noqa: F401
    DraftController,
    SpeculativeEngine,
    resolve_draft_bits,
    resolve_draft_kv_bits,
)
