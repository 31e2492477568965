"""Draft-token proposers for self-speculative decoding (counterpart of
``apex_tpu/serve/drafter.py``).

``propose(tokens, k) -> up to k draft ids`` runs on the host between
steps. The shipped drafter is prompt lookup: find the most recent earlier
occurrence of the history's last ``ngram`` tokens and propose what followed
it. Correctness never depends on the drafter — the engine accepts only the
drafts its own verify pass would have sampled.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable

__all__ = ["Drafter", "NGramDrafter"]


@runtime_checkable
class Drafter(Protocol):
    """Host-side draft proposer. ``tokens`` is the request's full history
    (prompt + generated so far); return at most ``k`` draft ids — an empty
    list opts the slot out of this step's speculation."""

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        ...


class NGramDrafter:
    """Prompt-lookup drafter: match the last ``ngram`` tokens against the
    most recent earlier occurrence in the history and propose the tokens
    that followed it. ``min_context``: shorter histories never propose."""

    def __init__(self, ngram: int = 3, min_context: int = 8):
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        self.ngram = ngram
        self.min_context = max(min_context, ngram + 1)

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        t = tokens if isinstance(tokens, list) else list(tokens)
        n = len(t)
        if k < 1 or n < self.min_context:
            return []
        tail = t[n - self.ngram:]
        # most recent earlier occurrence wins
        for i in range(n - self.ngram - 1, -1, -1):
            if t[i:i + self.ngram] == tail:
                return t[i + self.ngram:i + self.ngram + k]
        return []
