"""Draft-model-free speculative drafting: the prompt-lookup n-gram proposer
(counterpart of ``midgpt_tpu.serving.speculate``; pure Python).

A request's draft is read out of its own token history: find the most
recent earlier occurrence of the context's suffix and propose the tokens
that followed it. The engine verifies every draft in one multi-row
dispatch (``serving.engine.verify_dispatch``), so a wrong draft costs
throughput, never correctness.

Drafts cover positions ``len(ctx) + 1, len(ctx) + 2, ...``: the engine
takes position ``len(ctx)`` itself from the carried logits (row 0 of the
verify dispatch). An n-gram draft is deterministic given the context, so
its draft distribution is one-hot (``q(t) = 1``) and the engine never
builds a dense ``[S, spec_len, V]`` tensor for it; a proposer that
samples from a real distribution opts into the dense path through
:class:`SoftProposer`.
"""

from __future__ import annotations

import typing as tp


class Proposer(tp.Protocol):
    """What the engine calls once per verify dispatch."""

    def propose(self, ctx: tp.Sequence[int], n: int) -> tp.List[int]:
        """Up to ``n`` draft tokens for positions ``len(ctx) + 1, ...``;
        fewer (or none) is fine: the dispatch masks the missing rows."""
        ...


class SoftProposer(tp.Protocol):
    """A proposer that samples its drafts from a real distribution.

    Marked by ``soft = True``. The engine calls :meth:`propose_soft` and
    hands the ``[n_drafted, V]`` f32 rows to the sampled verify dispatch,
    so acceptance ``u * q(t) <= p(t)`` and the residual ``max(p - q, 0)``
    see the proposer's true ``q``: row ``j`` must be the distribution
    draft ``j`` was drawn from. The draft's randomness must come from
    ``seed`` (the request's sampling seed) and the context, never from
    global state, so drafts are a function of the request alone."""

    soft: bool

    def propose_soft(self, ctx: tp.Sequence[int], n: int, seed: int
                     ) -> tp.Tuple[tp.List[int], tp.Any]:
        """``(tokens, probs)``, probs array-like ``[len(tokens), V]``."""
        ...


class NgramProposer:
    """Prompt-lookup drafting: suffix-match the context against itself.

    For suffix lengths ``max_ngram`` down to ``min_ngram``, scan the
    earlier occurrences of the suffix right to left (recency wins). An
    occurrence whose continuation fills the whole draft returns at once;
    otherwise the longest partial continuation at that length wins if it
    holds at least two tokens. The continuation's first token is skipped:
    it guesses position ``len(ctx)``, which the engine computes itself."""

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1):
        if not max_ngram >= min_ngram >= 1:
            raise ValueError(
                f"need max_ngram >= min_ngram >= 1, got {max_ngram}, "
                f"{min_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, ctx: tp.Sequence[int], n: int) -> tp.List[int]:
        if n < 1:
            raise ValueError(f"draft length must be >= 1, got {n}")
        toks = [int(t) for t in ctx]
        length = len(toks)
        for k in range(min(self.max_ngram, length - 1), self.min_ngram - 1,
                       -1):
            suffix = toks[length - k :]
            best: tp.List[int] = []
            for i in range(length - k - 1, -1, -1):
                if toks[i : i + k] == suffix:
                    cont = toks[i + k : i + k + n + 1]
                    if len(cont) == n + 1:
                        return cont[1:]
                    if len(cont) > len(best):
                        best = cont
            if len(best) >= 2:
                return best[1 : n + 1]
        return []
