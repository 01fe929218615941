from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    packed_staleness,
    repack_params,
    row_chunks,
)
