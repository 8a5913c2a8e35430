"""Draft proposers for speculative decoding.

Twin of ``apex_tpu/serving/speculation.py``.  Speculative decoding
splits a decode iteration into *draft* (guess the next few tokens
cheaply) and *verify* (score every guess in one multi-token engine
step, ``DecodeEngine.verify_sampled``).  Acceptance keeps the output
identical to one-token decode by construction: the accepted tokens are
the drafts that MATCH the model's own token at their position (its
argmax, or a stochastic request's counter-keyed sample, which makes it
rejection sampling), followed by the model's own next token.

The default proposer is zero-weight **prompt-lookup / n-gram
drafting**: generation often copies spans that already occurred in the
request's own context, so the best free guess for what follows the
current suffix is what followed it last time.  :class:`DraftSource` is
the pluggable interface (a small-model drafter is a subclass).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["DraftSource", "NgramDraft"]


class DraftSource:
    """Interface for draft proposers.

    ``propose(tokens, k)`` receives the request's whole history (prompt
    and everything generated, INCLUDING the pending token whose K/V the
    next engine step writes) and returns up to ``k`` guesses for the
    tokens that follow; ``[]`` means no guess (the request decodes one
    token that iteration).  Drafts are hints, never outputs; ``propose``
    runs on the host once a decoding request an iteration, so it must
    be cheap; and it must be deterministic in the history, so replays
    reproduce the per-step accounting.
    """

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError

    def reset(self) -> None:
        """Drop any cross-request state (stateless by default)."""


class NgramDraft(DraftSource):
    """Zero-weight prompt-lookup drafts from the request's own history.

    For ``n`` from ``max_ngram`` down to ``min_ngram``: take the last
    ``n`` tokens, find the most recent EARLIER occurrence of that
    n-gram, and propose the token that followed it; repeat on the
    extended history up to ``k`` tokens.  ``history_window`` bounds the
    scan to the last N tokens.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 history_window: Optional[int] = 512):
        if max_ngram < min_ngram or min_ngram < 1:
            raise ValueError(
                f"need max_ngram >= min_ngram >= 1; got "
                f"max_ngram={max_ngram} min_ngram={min_ngram}")
        if history_window is not None and history_window < 2:
            raise ValueError(
                f"history_window must be >= 2, got {history_window}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.history_window = history_window

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        hist = list(tokens)
        if self.history_window is not None \
                and len(hist) > self.history_window:
            hist = hist[len(hist) - self.history_window:]
        out: List[int] = []
        # one token at a time, each guess appended to the working
        # history: re-matching the extended suffix extrapolates periodic
        # tails to a whole k-token draft
        for _ in range(max(0, k)):
            nxt = self._lookup_next(hist)
            if nxt is None:
                break
            out.append(nxt)
            hist.append(nxt)
        return out

    def _lookup_next(self, hist: List[int]) -> Optional[int]:
        """The token after the most recent earlier occurrence of the
        longest matching suffix n-gram (None = no occurrence down to
        ``min_ngram``)."""
        n_hist = len(hist)
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            suffix = tuple(hist[n_hist - n:])
            for i in range(n_hist - n - 1, -1, -1):
                if tuple(hist[i:i + n]) == suffix:
                    return int(hist[i + n])
        return None
