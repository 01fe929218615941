"""Offline tuning tools: the static-analysis toolchain turned into
artifacts the runtime consumes (``repro_torch.tuning.calibrate`` writes
``CompressionPlan`` JSON files for ``launch.serve --plan``)."""
from repro_torch.core.calibrate import (  # noqa: F401
    CalibrationResult,
    calibrate,
    derive_int_bits,
)
