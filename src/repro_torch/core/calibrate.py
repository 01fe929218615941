"""Model calibration: the static-analysis flow aimed at a whole LM.

Port of ``repro.core.calibrate``, the deployment end of the paper's loop
(Fig. 7, lifted from one traced kernel to a model). Sample batches run
through the model, and each leaf gets its width from evidence:

* **integer streams** get exact widths from the range analysis
  (``core.range_analysis``), seeded by ``ModelConfig`` bounds through
  ``input_specs`` (token ids < vocab, positions < max_seq_len, expert
  ids < n_experts): the launch knowledge of Section 4.2, derived rather
  than asserted;
* **float parameter leaves** get the largest-footprint-first fixpoint
  search of ``precision_tuning.tune_tensors`` (Section 4.1), each trial
  judged by a ``QualitySpec`` (typically ``loss_delta``: max |Δloss| in
  nats over the calibration batches). On the card every trial's round
  trip is the ``truncate`` and ``convert`` kernels.

The output is a per-leaf mixed-width ``CompressionPlan`` that serving
(``launch/serve.py --calibrate`` or ``--plan``) consumes. Integer widths
live under ``inputs/...`` keys: they describe the token, position and
routing streams, never parameter leaves, so ``repack`` over the plan
leaves the parameters alone.

A quantized leaf enters the loss as f32, as the reference's does; the
layers then cast it to the activations' dtype where they use it.
Quality is only guaranteed for inputs like the calibration batches;
the paper says the same of its tuning samples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.compress import CompressionPlan, path_str, uniform_plan
from repro_torch.core.formats import FLOAT_LADDER
from repro_torch.core.precision_tuning import quantize_dequantize, tune_tensors
from repro_torch.core.quality import QualitySpec
from repro_torch.core.range_analysis import analyze, input_specs
from repro_torch.core.tensor_store import tree_map_with_path


def derive_int_bits(cfg, max_seq_len: int) -> Dict[str, Tuple[int, bool]]:
    """Exact integer widths of the model's input streams, derived by the
    interval analysis of a traced stream function seeded with
    ``input_specs(cfg, max_seq_len)``. Keys are ``inputs/<name>``, which
    never collide with parameter paths."""
    specs = input_specs(cfg, max_seq_len)
    names = list(specs)

    def stream(*vals):
        outs = []
        for n, v in zip(names, vals):
            if n == "positions":
                # the decode step's successor position, clamped in bounds:
                # the add and min transfers instead of the identity
                v = torch.clamp(v + 1, max=max_seq_len - 1)
            outs.append(v)
        return tuple(outs)

    examples = [torch.zeros((4,), dtype=torch.int32) for _ in names]
    report = analyze(stream, *examples,
                     input_ranges=[specs[n] for n in names])
    out: Dict[str, Tuple[int, bool]] = {}
    for n, itv in zip(names, report.out_intervals):
        b = itv.bits()
        if b:
            out["inputs/" + n] = b
    return out


def _extra_inputs(cfg, batch_size: int) -> Dict[str, torch.Tensor]:
    """The family-specific zero riders the LM batch dict expects."""
    extra: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.zeros(
            (batch_size, cfg.num_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        extra["frames"] = torch.zeros(
            (batch_size, cfg.encoder_seq, cfg.d_model))
    return extra


def _leaves_sorted(tree: Any, path: Tuple[Any, ...] = ()):
    """(path, leaf) in the reference's pytree order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_sorted(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_sorted(v, path + (i,))
    else:
        yield path, tree


def float_leaves(params: Any, min_ndim: int = 2) -> Dict[str, torch.Tensor]:
    """The tunable float tensors of a parameter tree, keyed by
    ``path_str`` (the keys ``uniform_plan`` and ``repack`` use), in the
    reference's leaf order, which orders the search's ties."""
    return {path_str(path): leaf for path, leaf in _leaves_sorted(params)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.ndim >= min_ndim}


@dataclasses.dataclass
class CalibrationResult:
    """A tuned plan and the evidence for it."""

    cfg_name: str
    plan: CompressionPlan
    quality: QualitySpec
    ref_loss: float               # mean reference loss over the batches
    metric: float                 # achieved quality metric at the plan
    uniform_metric: float         # same metric for the uniform baseline
    mean_float_bits: float        # size-weighted, 32s included
    uniform_bits: int             # the width the plan competes against
    footprint_ratio: float        # plan bytes / f32 bytes (float leaves)
    uniform_ratio: float          # uniform-plan bytes / f32 bytes
    tune_evals: int
    n_batches: int
    batch_size: int
    seq_len: int

    @property
    def accepted(self) -> bool:
        """The tuned plan sits inside the quality gate."""
        th = self.quality.threshold
        if self.quality.kind == "ssim":
            return self.metric >= th - 1e-6
        return self.metric <= th + 1e-9

    @property
    def beats_uniform(self) -> bool:
        """Strictly narrower mean float width than the uniform plan."""
        return self.mean_float_bits < self.uniform_bits

    def summary(self) -> Dict[str, Any]:
        return {
            "config": self.cfg_name,
            "quality_kind": self.quality.kind,
            "quality_threshold": self.quality.threshold,
            "ref_loss": self.ref_loss,
            "metric": self.metric,
            "uniform_metric": self.uniform_metric,
            "mean_float_bits": self.mean_float_bits,
            "uniform_bits": self.uniform_bits,
            "footprint_ratio": self.footprint_ratio,
            "uniform_ratio": self.uniform_ratio,
            "tune_evals": self.tune_evals,
            "n_float_leaves": len(self.plan.float_bits),
            "n_int_streams": len(self.plan.int_bits),
            "accepted": self.accepted,
            "beats_uniform": self.beats_uniform,
        }


def calibrate(
    cfg,
    quality: QualitySpec,
    *,
    n_batches: int = 2,
    batch_size: int = 2,
    seq_len: int = 16,
    seed: int = 0,
    params: Optional[Any] = None,
    ladder: Sequence[int] = FLOAT_LADDER,
    min_ndim: int = 2,
    max_seq_len: Optional[int] = None,
    batches: Optional[List[Dict[str, torch.Tensor]]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> CalibrationResult:
    """Run the calibration pass on one ``ModelConfig``, on the card
    unless ``device`` says otherwise.

    Floats: each float leaf of ``ndim >= min_ndim`` is a tuning group;
    the search round-trips candidates through the Table 3 ladder and
    judges the stacked per-batch losses against the reference run by
    ``quality``. Ints: widths from ``derive_int_bits``. ``params=None``
    initializes parameters from ``seed`` on the device, as
    ``ServeEngine`` does (seed 0), so what the tuner sees is what the
    engine packs. ``batches`` replaces the ``SyntheticTokens`` stream of
    ``n_batches`` batches (B = ``batch_size``, T = ``seq_len``) from
    ``seed``: parity runs feed the reference's batches."""
    from repro_torch.data import pipeline
    from repro_torch.models.lm import LM

    lm = LM(cfg, device=device)
    if params is None:
        params = lm.init(torch.Generator(device=lm.device).manual_seed(seed))
    if batches is None:
        data = pipeline.SyntheticTokens(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=batch_size, seed=seed)
        extra = _extra_inputs(cfg, batch_size)
        batches = [data.batch_at(i).as_dict(dict(extra))
                   for i in range(n_batches)]
    batches = [{k: v.to(lm.device) for k, v in b.items()} for b in batches]
    n_batches = len(batches)
    batch_size, seq_len = (int(s) for s in batches[0]["tokens"].shape)

    tensors = float_leaves(params, min_ndim)
    sizes = {k: max(v.numel(), 1) for k, v in tensors.items()}

    def apply_fn(quantized: Dict[str, torch.Tensor]) -> torch.Tensor:
        def splice(path, leaf):
            return quantized.get(path_str(path), leaf)
        spliced = tree_map_with_path(splice, params)
        with torch.no_grad():
            return torch.stack([lm.loss(spliced, b) for b in batches])

    ref = apply_fn(tensors)
    tuned = tune_tensors(apply_fn, tensors, quality, ladder, reference=ref)

    wbits = cfg.resolved_weight_bits
    plan = CompressionPlan(
        float_bits={k: b for k, b in tuned.formats.items() if b < 32},
        int_bits=derive_int_bits(cfg, max_seq_len or seq_len),
        tune_evals=tuned.evaluations,
    )

    def metric_at(widths: Dict[str, int]) -> float:
        q = {k: quantize_dequantize(v, widths.get(k, 32))
             for k, v in tensors.items()}
        return quality.metric(ref, apply_fn(q))

    return CalibrationResult(
        cfg_name=cfg.name,
        plan=plan,
        quality=quality,
        ref_loss=float(ref.mean()),
        metric=metric_at(tuned.formats),
        uniform_metric=metric_at({k: wbits for k in tensors}),
        mean_float_bits=tuned.mean_bits(sizes),
        uniform_bits=wbits,
        footprint_ratio=plan.footprint_ratio(tensors),
        uniform_ratio=uniform_plan(
            params, wbits, min_ndim).footprint_ratio(tensors),
        tune_evals=tuned.evaluations,
        n_batches=n_batches,
        batch_size=batch_size,
        seq_len=seq_len,
    )
