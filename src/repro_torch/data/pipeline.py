"""Deterministic, restart-exact synthetic token stream.

Port of ``repro.data.pipeline``. The batch of a step is drawn from a
``torch.Generator`` seeded from (seed, step, host_index) alone, so any
host can make its shard of any step with no coordination, and a
restart replays the same tokens. The marginal is the reference's,
``floor(vocab * u^3)`` for u uniform in [0, 1): ids in [0, vocab), mass
at the small ids, mean ids / vocab near 1/4. JAX's counter-mode PRNG
cannot be reproduced in torch, so the batches match the reference's in
distribution only. Tokens are drawn on the CPU, the same whatever the
device that trains on them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import torch

_MASK = (1 << 64) - 1


def _mix(*words: int) -> int:
    """splitmix64 over the words: a 63-bit seed."""
    h = 0
    for w in words:
        h = (h + (w & _MASK) + 0x9E3779B97F4A7C15) & _MASK
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK
        h ^= h >> 31
    return h >> 1


@dataclasses.dataclass(frozen=True)
class TokenBatch:
    tokens: torch.Tensor              # (B, S) int32 in [0, vocab)
    labels: torch.Tensor              # (B, S) int32
    step: int

    def as_dict(self, extra: Optional[Dict] = None) -> Dict:
        d = {"tokens": self.tokens, "labels": self.labels}
        if extra:
            d.update(extra)
        return d


@dataclasses.dataclass
class SyntheticTokens:
    """Sharded synthetic LM stream; its state is the step counter."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0
    host_index: int = 0
    host_count: int = 1

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.host_count

    def batch_at(self, step: int) -> TokenBatch:
        """This host's shard of global step ``step``."""
        gen = torch.Generator().manual_seed(
            _mix(self.seed, step, self.host_index))
        u = torch.rand((self.host_batch, self.seq_len + 1), generator=gen)
        ids = (u ** 3 * self.vocab_size).to(torch.int32).clamp(
            0, self.vocab_size - 1)
        return TokenBatch(tokens=ids[:, :-1], labels=ids[:, 1:], step=step)

    def __iter__(self) -> Iterator[TokenBatch]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b

    # -- checkpointable state ---------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: Dict) -> None:
        self.step = int(d["step"])
        self.seed = int(d["seed"])
