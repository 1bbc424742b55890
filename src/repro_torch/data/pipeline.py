"""Deterministic, seekable, host-sliced synthetic token pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only), batch for batch the
reference's. Every batch is a function of (seed, step, process_index):

* a run restarted at step k sees the stream an uninterrupted run saw
  (a checkpoint stores the step, no iterator state);
* each process draws only its slice of the global batch;
* the "documents" are Zipf-ish token streams with short-range copies,
  so that a model's loss falls on them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1
    frontend_tokens: int = 0      # > 0 -> also emit stub frontend embeds
    d_model: int = 0

    def __post_init__(self):
        if self.global_batch % self.process_count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.process_count} processes")
        self.local_batch = self.global_batch // self.process_count

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.process_index])
        )
        b, s, v = self.local_batch, self.seq_len, self.vocab_size
        # zipfian unigrams + short-range copy structure
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        tokens = (base % (v - 2)) + 1
        lag = int(rng.integers(2, 8))
        copy_mask = rng.random((b, s)) < 0.35
        shifted = np.roll(tokens, lag, axis=1)
        tokens = np.where(copy_mask, shifted, tokens)
        tokens[:, 0] = 1  # BOS
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1  # masked
        out = {"tokens": tokens.astype(np.int32),
               "labels": labels.astype(np.int32)}
        if self.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (b, self.frontend_tokens, self.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
