"""Models: the dense decoder family on packed weights and a packed KV cache."""
