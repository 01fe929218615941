"""Distribution: for now only the error-feedback half of gradient
compression (the ring reduce and sharding are ROADMAP A15)."""
