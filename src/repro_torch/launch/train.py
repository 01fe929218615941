"""Training launcher.

    python -m repro_torch.launch.train --arch qwen3_8b --steps 1000 \
        --checkpoint-dir ckpt/qwen3 [--reduced] [--device cpu] \
        [--pack-params [--repack-every N] [--plan plan.json]] \
        [--grad-compress-bits 8] [--metrics-out events.jsonl]

Port of ``repro.launch.train`` with its flags, plus ``--device`` (cuda
by default; ``cpu`` runs the kernels' plain versions). ``--reduced``
trains the small same-family config and clamps ``--seq-len`` to 128 and
``--global-batch`` to 4, as the reference does. Without it the full
config trains on the one card (the reference builds a production mesh
there, which is ROADMAP A15): a config that does not fit fails with
CUDA's out-of-memory error. ``--mode`` is accepted and unused, as in the
reference; ``--multi-pod`` only shapes that mesh, so without
``--reduced`` it is a usage error (exit 2). The run resumes from the
newest checkpoint under ``--checkpoint-dir``, checkpoints on SIGTERM and
SIGINT, and prints the reference's last line, ``final loss: ...
steps: ... stragglers: ...``.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--mode", default="tp", choices=["tp", "zero"],
                    help="accepted and unused, as in the reference")
    ap.add_argument("--multi-pod", action="store_true",
                    help="shapes the multi-pod mesh (ROADMAP A15); "
                         "only with --reduced, where it has no effect")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config for single-host runs")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--grad-compress-bits", type=int, default=None)
    ap.add_argument("--pack-params", action="store_true",
                    help="packed-master training: params live as "
                         "PackedTensor codes at the planned width; the "
                         "optimizer owns dense masters")
    ap.add_argument("--repack-every", type=int, default=1,
                    help="re-encode changed masters to codes every N "
                         "steps (packed-master mode)")
    ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                    help="packed-master plan source: a per-leaf plan "
                         "JSON instead of the uniform config width")
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="stream train.step / train.repack / "
                         "train.metrics events to this JSONL file")
    ap.add_argument("--metrics-interval", type=int, default=1,
                    metavar="N",
                    help="emit a train.step event every N steps")
    args = ap.parse_args(argv)
    if args.multi_pod and not args.reduced:
        ap.error("--multi-pod shapes the production mesh, which the port "
                 "does not build yet (ROADMAP A15); the full config "
                 "trains on one card without it")

    from repro_torch.configs import get_config
    from repro_torch.train import Trainer, TrainConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        args.seq_len = min(args.seq_len, 128)
        args.global_batch = min(args.global_batch, 4)

    tc = TrainConfig(
        steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=max(args.steps // 10, 1),
        grad_compress_bits=args.grad_compress_bits
        or cfg.compression.grad_bits,
        pack_params=args.pack_params,
        repack_every=args.repack_every,
        plan_path=args.plan,
        metrics_out=args.metrics_out,
        metrics_interval=args.metrics_interval,
    )
    metrics = Trainer(cfg, tc, device=args.device).run(install_signals=True)

    print(f"final loss: {metrics['final_loss']:.4f}  "
          f"steps: {metrics['last_step'] + 1}  "
          f"stragglers: {metrics['straggler_events']}")
    if args.metrics_out:
        print(f"wrote telemetry to {args.metrics_out}")


if __name__ == "__main__":
    main()
