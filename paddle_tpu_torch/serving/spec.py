"""Self-speculative drafting — prompt-lookup (n-gram) proposals (port of
``paddle_tpu/serving/spec.py``, which is numpy; the port keeps its own
copy).

The draft model is the request's own token history: find the most
recent earlier occurrence of the trailing n-gram and propose what
followed it.  Everything here is host-side numpy over the slot's
``prompt + generated`` history: no model operations, no device traffic.
Draft quality moves throughput only: the batched verify step accepts or
resamples against the model's distribution
(``sampling.spec_accept``), so a miss makes that iteration one token,
as plain decode.  Proposals are always exactly ``k`` tokens (the verify
step has one shape): short matches and misses are padded by repeating
the last token.
"""
from __future__ import annotations

import numpy as np

__all__ = ["propose"]


def propose(history, k, max_ngram=3):
    """Draft ``k`` tokens for a slot from its own token history.

    Tries the longest trailing n-gram first (``n = max_ngram .. 1``),
    looking for its MOST RECENT earlier occurrence that has at least one
    continuation token; proposes the ``k`` tokens that followed, padded
    by repeating the history's last token.  Returns ``(draft (k,) int32,
    hit bool)`` — ``hit`` False means every position is pad."""
    h = np.asarray(history, np.int32).reshape(-1)
    k = int(k)
    n_h = int(h.size)
    fill = int(h[-1]) if n_h else 0
    draft = np.full((k,), fill, np.int32)
    if n_h < 2:
        return draft, False
    for n in range(min(int(max_ngram), n_h - 1), 0, -1):
        tail = h[n_h - n:]
        # windows over h[:-1]: starts 0..n_h-1-n, so every match has at
        # least one continuation token and the trailing n-gram itself
        # (start n_h-n) is left out
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        starts = np.nonzero((windows == tail).all(axis=1))[0]
        if starts.size:
            i = int(starts[-1])                    # most recent match
            cont = h[i + n:i + n + k]
            draft[:cont.size] = cont
            return draft, True
    return draft, False
