"""Serving launcher: batched greedy decode with packed weights and KV.

    python -m repro_torch.launch.serve --arch qwen3_8b --pack-weights \
        [--reduced] [--requests 16] [--max-new-tokens 8] \
        [--max-seq-len 64] [--slots 4] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given (and raises
without a card). ``--reduced`` serves the small same-family config; by
default the full-width config is served (the reference's launcher
cannot turn ``--reduced`` off). Weights are random from a fixed seed;
prompts are 4 random token ids each, from numpy seed 0.
"""
from __future__ import annotations

import argparse

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
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.serving import ServeEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    eng = ServeEngine(cfg, max_seq_len=args.max_seq_len,
                      max_slots=args.slots, pack_weights=args.pack_weights,
                      device=args.device)
    rng = np.random.default_rng(0)
    rids = [eng.submit([int(t) for t in rng.integers(1, cfg.vocab_size, 4)],
                       max_new_tokens=args.max_new_tokens)
            for _ in range(args.requests)]
    stats = eng.run_until_drained()
    done = sum(1 for r in rids if eng.result(r) is not None)
    print(f"completed {done}/{len(rids)} requests on {eng.device}; "
          f"{stats['tokens']} tokens in {stats['ticks']} ticks; "
          f"slots={stats['slots']}; wall {stats['wall_s']:.3f} s")


if __name__ == "__main__":
    main()
