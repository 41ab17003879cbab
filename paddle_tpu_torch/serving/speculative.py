"""Self-speculative drafting — propose k tokens per pool read.

The port's own copy of ``paddle_tpu/serving/speculative.py`` (numpy only:
the port imports nothing of the JAX package).

Decode is HBM-bound: each step reads every parameter plus the live KV
pool to emit ONE token (docs/PERF.md round 5).  Speculative decoding
re-prices that read: draft ``k`` tokens cheaply on the host, then verify
all of them in one batched forward through the same per-slot
static-cache branch the plain decode uses — every position's logits come
back, the longest draft prefix that matches the model's own (greedy)
choices is accepted, and the step emits ``accepted + 1`` tokens for one
pool read.  Greedy output is *token-identical* to the non-speculative
path by construction: an accepted draft is accepted precisely because it
equals the token the model would have emitted.

The default drafter is **prompt-lookup / n-gram**: find the most recent
earlier occurrence of the context's trailing n-gram and propose the
tokens that followed it.  It is free (no draft model, no extra device
work) and strong exactly where speculative decoding pays off —
contexts with self-similar continuations (shared prompts, quoting,
code, the loops small models fall into).  A learned draft model drops
into the same seam: ``Engine(drafter=...)`` takes any callable
``drafter(context_ids, n) -> n proposed ids``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["NgramDrafter"]


class NgramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most
    recent earlier occurrence of the context's trailing n-gram.

    Args:
        max_ngram: longest suffix n-gram to probe (longest first — a
            longer match is a stronger prediction).
        min_ngram: shortest n-gram worth matching; below it the drafter
            pads with the last context token (a cheap "repeat" guess
            that costs nothing when wrong).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def __call__(self, context, n: int) -> np.ndarray:
        """``context`` (1-D int token ids, prompt + generated so far) →
        ``n`` proposed next tokens (int64)."""
        ctx = np.asarray(context, np.int64).reshape(-1)
        out = np.full(n, ctx[-1] if ctx.size else 0, np.int64)
        if n < 1 or ctx.size < self.min_ngram + 1:
            return out
        for g in range(min(self.max_ngram, ctx.size - 1), self.min_ngram - 1,
                       -1):
            suffix = ctx[-g:]
            # windows of width g ending strictly before the suffix itself
            hay = np.lib.stride_tricks.sliding_window_view(ctx[:-1], g)
            matches = np.nonzero((hay == suffix).all(axis=1))[0]
            if matches.size == 0:
                continue
            start = int(matches[-1]) + g   # continuation of the LAST match
            cont = ctx[start:start + n]
            out[:cont.size] = cont
            if cont.size < n and cont.size:
                out[cont.size:] = cont[-1]
            return out
        return out

    def __repr__(self):
        return (f"NgramDrafter(max_ngram={self.max_ngram}, "
                f"min_ngram={self.min_ngram})")
