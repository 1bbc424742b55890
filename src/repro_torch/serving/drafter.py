"""Prompt-lookup n-gram drafter for speculative decoding.

Port of ``repro/serving/drafter.py``, with numpy only. Prompts of
extraction, summarisation, code edits and chat with quoting repeat long
spans of their own context, so the tokens that followed the most recent
earlier occurrence of the current suffix are a good guess for what comes
next. The drafter is a host-side string match: no device work, and
deterministic, so a speculative serve replays exactly.

Drafted tokens are only candidates: the engine's verify step checks them
against the model's own greedy argmax, so a bad draft costs verify rows,
never correctness.
"""

from __future__ import annotations

import numpy as np


class NgramDrafter:
    """Longest-suffix prompt-lookup drafter.

    For a context (prompt and tokens generated so far, ending in the last
    emitted token), find the longest suffix of length <= ``ngram`` that
    also occurs earlier in the context; among equal-length matches take
    the most recent; propose up to ``k`` tokens that followed it. Returns
    fewer than ``k``, possibly none, when the continuation runs out or no
    suffix recurs.
    """

    def __init__(self, *, ngram: int = 3):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = ngram

    def draft(self, context, k: int) -> list[int]:
        """Propose up to ``k`` continuation tokens for ``context``."""
        ctx = np.asarray(context, dtype=np.int64)
        n = ctx.shape[0]
        if k <= 0 or n < 2:
            return []
        for g in range(min(self.ngram, n - 1), 0, -1):
            pat = ctx[n - g:]
            # windows starting at 0 .. n-1-g: every earlier occurrence,
            # the suffix itself excluded
            windows = np.lib.stride_tricks.sliding_window_view(ctx[:n - 1], g)
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            if hits.size:
                i = int(hits[-1])                    # the most recent
                cont = ctx[i + g:i + g + k]
                if cont.size:
                    return [int(t) for t in cont]
        return []
