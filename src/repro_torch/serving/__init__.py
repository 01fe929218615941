"""Serving: the dense-KV greedy ``ServeEngine``."""
from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
