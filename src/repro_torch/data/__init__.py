from repro_torch.data.pipeline import SyntheticTokens, TokenBatch  # noqa: F401
