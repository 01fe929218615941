"""Serving launcher: batched decode with packed weights and KV.

    python -m repro_torch.launch.serve --arch qwen3_8b --pack-weights \
        [--reduced] [--requests 16] [--max-new-tokens 8] \
        [--max-seq-len 64] [--slots 4] [--device cpu] [--kv-bits 8] \
        [--paged] [--kv-page-size 16] [--kv-pool-pages N] \
        [--paged-attn | --gather-attn] \
        [--plan plan.json | --calibrate] [--save-plan plan.json] \
        [--quality-kind loss_delta] [--quality-threshold 0.05] \
        [--calib-batches 2] [--speculative 4] [--draft-bits 12] \
        [--adaptive] [--sample] [--sample-seed N] \
        [--metrics-out metrics.jsonl] [--metrics-interval N]

``--arch`` names any config of ``repro_torch.configs``: the dense and
MoE families, paligemma_3b (vlm), whisper_small (encdec),
falcon_mamba_7b (ssm) and recurrentgemma_9b (hybrid). The recurrent
families (ssm, hybrid) cannot page or speculate: ``--paged`` and
``--speculative`` exit with the engine's reason, as do other settings
the engine refuses. Runs on the CUDA device unless ``--device cpu`` is
given (and raises without a card). ``--reduced`` serves the small same-family config; by
default the full-width config is served (the reference's launcher
cannot turn ``--reduced`` off). ``--paged`` pages the KV cache: pages
of ``--kv-page-size`` rows from a pool of ``--kv-pool-pages`` (default
slots x pages per sequence), per-request page tables and shared prompt
prefixes; attention reads the pool through the table, or, with
``--gather-attn`` (CPU only), through the gathered dense view. Weights
are random from a fixed seed; prompts are 4 random token ids each, from
numpy seed 0.

``--speculative K`` serves through the narrow-draft stepper: a draft
re-encoded one ladder step down (``--draft-bits`` overrides the width)
proposes K tokens a tick and the full-width model verifies them; the
tokens are the plain engine's, and ``--adaptive`` lets the draft
controller retune (width, K) from live acceptance. ``--sample`` samples
(rejection sampling under speculation) instead of taking the argmax,
reproducibly under ``--sample-seed``. ``--plan`` packs the weights at a
per-leaf plan file (the reference's JSON); a plan with ``kv_bits``
entries sets per-layer KV widths. ``--calibrate`` runs the calibration
pass (``core.calibrate``) first, on the weights the engine then packs,
gated by ``--quality-kind`` / ``--quality-threshold`` over
``--calib-batches`` batches, and serves the tuned mixed-width plan;
``--save-plan`` writes the served plan for later ``--plan`` runs.
``--kv-bits`` sets the KV width. ``--metrics-out`` streams the spans,
events and ``serve.metrics`` snapshots (every ``--metrics-interval``
ticks, and at the drain's end) to a JSONL file, which
``python -m repro_torch.obs.validate`` checks, and prints the metrics
registry's summary at the end.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=64)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the small same-family config")
    ap.add_argument("--pack-weights", action="store_true",
                    help="pack the weights at the config's planned width")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--paged", action="store_true",
                    help="page the KV cache: per-request page tables over "
                         "a shared page pool")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="KV rows per page (must divide --max-seq-len)")
    ap.add_argument("--kv-pool-pages", type=int, default=None,
                    help="pool pages (default: slots x pages per "
                         "sequence; fewer over-commit slots)")
    ap.add_argument("--paged-attn", dest="paged_attn", action="store_true",
                    default=True,
                    help="paged only: attend through the page table "
                         "(the default)")
    ap.add_argument("--gather-attn", dest="paged_attn",
                    action="store_false",
                    help="paged only, CPU only: attend over the gathered "
                         "dense view (the parity oracle)")
    ap.add_argument("--kv-bits", type=int, default=None,
                    help="KV-cache width (default: the config's)")
    ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                    help="pack weights at this per-leaf plan; its kv_bits "
                         "entries set per-layer KV widths")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="draft K tokens a tick through the narrow plan; "
                         "0 = plain engine")
    ap.add_argument("--draft-bits", type=int, default=None,
                    help="draft weight width (default: the config's knob, "
                         "else one Table 3 step below weight_bits)")
    ap.add_argument("--adaptive", action="store_true",
                    help="speculative only: retune (draft width, K) from "
                         "live acceptance")
    ap.add_argument("--sample", action="store_true",
                    help="sample tokens instead of the greedy argmax")
    ap.add_argument("--sample-seed", type=int, default=None,
                    help="pin the sampling nonce (reproducible drains)")
    ap.add_argument("--calibrate", action="store_true",
                    help="run the calibration pass first and serve the "
                         "tuned mixed-width plan")
    ap.add_argument("--save-plan", default=None, metavar="OUT_JSON",
                    help="write the served plan (from --plan/--calibrate) "
                         "to this file")
    ap.add_argument("--quality-kind", default="loss_delta",
                    choices=["loss_delta", "deviation"],
                    help="--calibrate acceptance metric")
    ap.add_argument("--quality-threshold", type=float, default=0.05,
                    help="--calibrate acceptance threshold (nats / %%)")
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="stream structured telemetry (spans, events, "
                         "serve.metrics snapshots) to this JSONL file")
    ap.add_argument("--metrics-interval", type=int, default=0, metavar="N",
                    help="emit a serve.metrics snapshot every N ticks "
                         "(0: only the final one at drain)")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.compress import CompressionPlan
    from repro_torch.models.lm import Refused
    from repro_torch.serving import ServeEngine, SpeculativeEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_bits:
        cfg = dataclasses.replace(cfg, compression=dataclasses.replace(
            cfg.compression, kv_bits=args.kv_bits))
    plan = None
    if args.plan and args.calibrate:
        raise SystemExit("--plan and --calibrate are exclusive")
    if args.plan:
        plan = CompressionPlan.load(args.plan)
        print(f"loaded plan {args.plan}: {len(plan.float_bits)} float "
              f"leaves, {len(plan.int_bits)} int streams, "
              f"{len(plan.kv_bits)} KV layers")
    elif args.calibrate:
        from repro_torch.core.calibrate import calibrate
        from repro_torch.core.quality import QualitySpec
        res = calibrate(
            cfg, QualitySpec(args.quality_kind, args.quality_threshold),
            n_batches=args.calib_batches, max_seq_len=args.max_seq_len,
            device=args.device)
        plan = res.plan
        print(f"calibrated {cfg.name}: mean float bits "
              f"{res.mean_float_bits:.1f} (uniform {res.uniform_bits}), "
              f"{args.quality_kind}={res.metric:.4g} "
              f"(gate {args.quality_threshold})")
    if args.save_plan:
        if plan is None:
            raise SystemExit("--save-plan needs --plan or --calibrate")
        plan.save(args.save_plan)
        print(f"wrote plan to {args.save_plan}")
    tracer = None
    if args.metrics_out:
        tracer = obs.Tracer()
        tracer.set_sink(args.metrics_out)
    kw = dict(max_seq_len=args.max_seq_len, max_slots=args.slots,
              pack_weights=args.pack_weights, plan=plan, paged=args.paged,
              kv_page_size=args.kv_page_size,
              kv_pool_pages=args.kv_pool_pages, paged_attn=args.paged_attn,
              device=args.device, greedy=not args.sample,
              sample_seed=args.sample_seed, tracer=tracer,
              metrics_interval=args.metrics_interval)
    try:
        if args.speculative:
            eng = SpeculativeEngine(cfg, k=args.speculative,
                                    draft_bits=args.draft_bits,
                                    adaptive=args.adaptive, **kw)
        else:
            eng = ServeEngine(cfg, **kw)
    except Refused as e:           # a mode or setting the engine refuses
        ap.error(str(e))
    rng = np.random.default_rng(0)
    rids = [eng.submit([int(t) for t in rng.integers(1, cfg.vocab_size, 4)],
                       max_new_tokens=args.max_new_tokens)
            for _ in range(args.requests)]
    stats = eng.run_until_drained()
    done = sum(1 for r in rids if eng.result(r) is not None)
    print(f"completed {done}/{len(rids)} requests on {eng.device}; "
          f"{stats['tokens']} tokens in {stats['ticks']} ticks; "
          f"slots={stats['slots']}; wall {stats['wall_s']:.3f} s")
    klb = eng.cfg.compression.kv_layer_bits
    print(f"kv widths: {list(klb) if klb else eng.cfg.compression.kv_bits}; "
          f"{'sampled' if args.sample else 'greedy'}")
    if args.paged:
        print(f"paged: page_size={stats['kv_page_size']} "
              f"pool_pages={stats['kv_pool_pages']} "
              f"pool_peak_utilization={stats['pool_peak_utilization']:.2f} "
              f"prefix_hit_rate={stats['prefix_hit_rate']:.2f}")
        print(f"paged-attn: fused={stats['paged_attn']} "
              f"pages_read={stats['kv_pages_read']} "
              f"(dense-equiv {stats['kv_pages_read_dense_equiv']}) "
              f"table_rows_uploaded={stats['table_rows_uploaded']} "
              f"table_upload_bytes={stats['table_upload_bytes']}")

    if args.speculative:
        print(f"speculative: k={stats['k']} draft_bits={stats['draft_bits']} "
              f"draft_kv_bits={stats['draft_kv_bits']} "
              f"acceptance={stats['acceptance_rate']:.3f} "
              f"committed/slot-tick={stats['committed_per_slot_tick']:.2f} "
              f"draft_weight_bytes={eng.draft_weight_read_bytes} "
              f"target_weight_bytes={eng.weight_read_bytes}")
        if args.adaptive:
            print(f"adaptive: retunes={stats['retunes']} "
                  f"post_retune_acceptance="
                  f"{stats['post_retune_acceptance']:.3f}")
    if tracer is not None:
        tracer.close()
        print(f"wrote telemetry to {args.metrics_out}")
        print(obs.console_summary(obs.REGISTRY))


if __name__ == "__main__":
    main()
