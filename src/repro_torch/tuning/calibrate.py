"""Calibration command: write a mixed-width CompressionPlan as JSON.

    python -m repro_torch.tuning.calibrate --arch qwen3_8b --out plan.json \
        [--quality-kind loss_delta] [--quality-threshold 0.05] \
        [--batches 2] [--batch-size 2] [--seq-len 16] [--seed 0] \
        [--max-seq-len 64] [--reduced] [--device cpu]

Runs ``core.calibrate.calibrate`` on the named config: integer stream
widths from the range analysis seeded by the config's bounds, float
leaf widths from the quality-gated precision-tuning search over
``--batches`` sample batches (random weights from ``--seed``; at seed
0 the weights ``launch.serve`` packs). Runs on the CUDA device
unless ``--device cpu`` is given. ``--reduced`` tunes the small
same-family config; by default the full-width one (the reference's
command cannot turn ``--reduced`` off). The plan file is what
``launch.serve --plan`` reads (``CompressionPlan``'s codec). Exits 1
when the tuned plan misses the quality gate.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--out", required=True, metavar="PLAN_JSON")
    ap.add_argument("--quality-kind", default="loss_delta",
                    choices=["loss_delta", "deviation"])
    ap.add_argument("--quality-threshold", type=float, default=0.05,
                    help="max |Δloss| in nats (loss_delta) or max mean "
                         "%%-deviation (deviation)")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="deployment sequence bound for the integer range "
                         "analysis (default: --seq-len)")
    ap.add_argument("--reduced", action="store_true",
                    help="tune the small same-family config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.calibrate import calibrate
    from repro_torch.core.quality import QualitySpec

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = calibrate(
        cfg, QualitySpec(args.quality_kind, args.quality_threshold),
        n_batches=args.batches, batch_size=args.batch_size,
        seq_len=args.seq_len, seed=args.seed, max_seq_len=args.max_seq_len,
        device=args.device)
    res.plan.save(args.out)
    print(json.dumps(res.summary(), indent=2, sort_keys=True))
    print(f"wrote {args.out}")
    if not res.accepted:
        raise SystemExit(
            f"tuned plan missed the quality gate: {res.quality.kind}="
            f"{res.metric:.4g} vs threshold {res.quality.threshold}")


if __name__ == "__main__":
    main()
