"""Deterministic synthetic LM data: every batch is a pure function of
(seed, step), so a restarted run replays the stream bit-exactly.

The port's own copy of ``repro.data.pipeline.SyntheticLMData`` (pure numpy;
the port imports nothing of the JAX package): the same draws, bit for bit,
as the reference's single-host stream of plain tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    """Zipf-distributed token stream with next-token labels."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"} int32 numpy arrays [global_batch, seq_len]."""
        # the reference seeds (seed, step, host_index); one host is index 0
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(step), 0]))
        # Zipf-ish: inverse-CDF over a power-law gives realistic skew
        u = rng.random((self.global_batch, self.seq_len + 1))
        toks = np.minimum((self.vocab * u ** 2.5).astype(np.int32),
                          self.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
