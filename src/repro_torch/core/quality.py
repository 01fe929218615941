"""Output-quality metrics (Section 5.3).

Port of ``repro.core.quality``, the metric families that gate the
precision-tuning search:

  * **SSIM** (graphics kernels): structural similarity of two images
    (Wang et al. 2004), the 11x11 Gaussian window (sigma 1.5) applied
    as two 11-tap passes, K1 = 0.01, K2 = 0.03;
  * **%-deviation**: mean relative deviation from the reference output,
    in percent;
  * **binary**: exact or incorrect;
  * **loss-delta** (the LM calibration gate, ``core.calibrate``): max
    |Δloss| in nats over the calibration batches.

Thresholds follow Section 6.1: *perfect* = SSIM 1.0 / 0% deviation /
exact; *high* = SSIM 0.9 / 10% deviation / exact. Inputs are tensors
(on any device) or anything ``torch.as_tensor`` takes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _gaussian_taps(size: int = 11, sigma: float = 1.5,
                   device=None) -> torch.Tensor:
    """The 1-D factor of the normalized 2-D Gaussian window."""
    ax = torch.arange(size, dtype=torch.float32, device=device) - (
        size - 1) / 2.0
    g = torch.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim(img_a, img_b, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM between two HxW (or HxWxC) float images in [0, range]."""
    a = _f32(img_a)
    b = _f32(img_b).to(a.device)
    if a.ndim == 3:                       # average channel SSIMs
        return torch.stack([ssim(a[..., c], b[..., c], data_range)
                            for c in range(a.shape[-1])]).mean()
    g = _gaussian_taps(device=a.device)
    pad = g.shape[0] // 2
    rows, cols = g.view(1, 1, 1, -1), g.view(1, 1, -1, 1)

    def filt(x):
        x4 = x[None, None]
        x4 = F.conv2d(x4, rows, padding=(0, pad))
        return F.conv2d(x4, cols, padding=(pad, 0))[0, 0]

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a ** 2
    var_b = filt(b * b) - mu_b ** 2
    cov = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean()


def percent_deviation(ref, out) -> torch.Tensor:
    """Mean relative deviation from the reference output, in percent."""
    ref = _f32(ref)
    out = _f32(out).to(ref.device)
    denom = torch.clamp(ref.abs(), min=1e-12)
    return 100.0 * ((out - ref).abs() / denom).mean()


def binary_correct(ref, out) -> bool:
    """Binary metric: value-for-value equality (e.g. a sorted order)."""
    r = torch.as_tensor(ref)
    o = torch.as_tensor(out).to(r.device)
    return r.shape == o.shape and bool((r == o).all())


def loss_delta(ref, out) -> float:
    """Max |out - ref| over (batched) scalar losses, in nats."""
    r = _f32(ref)
    return float((_f32(out).to(r.device) - r).abs().max())


@dataclasses.dataclass(frozen=True)
class QualitySpec:
    """A metric and its acceptance predicate, from the domain expert."""

    kind: str                # "ssim" | "deviation" | "binary" | "loss_delta"
    threshold: float         # SSIM lower bound / max %dev / max nats / n.a.

    def accepts(self, ref, out) -> bool:
        if self.kind == "ssim":
            if self.threshold >= 1.0:       # perfect: bit-identical output
                return binary_correct(ref, out)
            return float(ssim(ref, out)) >= self.threshold - 1e-6
        if self.kind == "deviation":
            dev = float(percent_deviation(ref, out))
            if self.threshold <= 0.0:       # perfect: no deviation at all
                return dev == 0.0
            return dev <= self.threshold * (1 + 1e-6)
        if self.kind == "loss_delta":
            return loss_delta(ref, out) <= self.threshold + 1e-9
        if self.kind == "binary":
            return binary_correct(ref, out)
        raise ValueError(f"unknown quality metric {self.kind!r}")

    def metric(self, ref, out) -> float:
        """The raw value the threshold gates, for reporting a tuned plan's
        achieved quality beside its threshold."""
        if self.kind == "ssim":
            return float(ssim(ref, out))
        if self.kind == "deviation":
            return float(percent_deviation(ref, out))
        if self.kind == "loss_delta":
            return loss_delta(ref, out)
        if self.kind == "binary":
            return 0.0 if binary_correct(ref, out) else 1.0
        raise ValueError(f"unknown quality metric {self.kind!r}")


# Section 6.1 thresholds.
PERFECT = {
    "ssim": QualitySpec("ssim", 1.0),
    "deviation": QualitySpec("deviation", 0.0),
    "binary": QualitySpec("binary", 0.0),
}
HIGH = {
    "ssim": QualitySpec("ssim", 0.9),
    "deviation": QualitySpec("deviation", 10.0),
    "binary": QualitySpec("binary", 0.0),
}
