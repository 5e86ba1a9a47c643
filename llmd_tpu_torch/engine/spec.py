"""Draft proposal for speculative decoding: n-gram prompt lookup.

The port of ``llmd_tpu/engine/spec.py``. A decode row's draft comes from
its own token history (Saxena, "Prompt Lookup Decoding", 2023): the
trailing n-gram of prompt + output is matched against earlier positions,
and the tokens that followed a match are proposed. No draft model and no
device work. The proposer runs for every decode row at every dispatch, so
its cost is in the new tokens, not the history: each request carries an
incremental index of its ``min_match``-gram end positions (the history
only grows; a preemption folds output into the prompt without changing the
token sequence). Verification (the runner's verify rows) and acceptance
(``sampler.accept_draft_tokens``, ``sampler.accept_counts``) decide what is
emitted: a wrong draft costs verify columns, never a wrong token.
"""

from __future__ import annotations


class NgramProposer:
    """Drafts up to ``k`` tokens by suffix n-gram lookup over a sequence's
    own history (JAX ``NgramProposer``).

    The candidates are the earlier end positions of the trailing
    ``min_match``-gram (a longer suffix match always contains one at the
    same end). They are scored by how far the match extends backwards,
    then by whether a full ``k`` tokens follow, then by recency."""

    # Candidates scored a proposal: a periodic history matches at every
    # period; the most recent few are enough, and keep the cost flat.
    _MAX_CANDIDATES = 32

    def __init__(self, min_match: int = 2, max_match: int = 8) -> None:
        if min_match < 1:
            raise ValueError(f"min_match={min_match} must be >= 1")
        self.min_match = min_match
        self.max_match = max(max_match, min_match)

    @staticmethod
    def new_state() -> dict:
        """A request's fresh index (``Request.spec_gram_state``): gram ->
        end positions, and how far the history is indexed."""
        return {"idx": {}, "upto": 0}

    def propose(self, tokens: list[int], k: int, state: dict | None = None) -> list[int]:
        """Up to ``k`` continuation tokens for ``tokens`` (the committed
        prompt + output); [] when the trailing gram never occurred before."""
        n = len(tokens)
        mm = self.min_match
        if k <= 0 or n < mm + 1:
            return []
        if state is None:
            state = self.new_state()
        idx = state["idx"]
        # Index the gram ending at each new position; the suffix itself
        # (end n) becomes a candidate once later tokens follow it.
        for e in range(max(state["upto"], mm), n):
            idx.setdefault(tuple(tokens[e - mm : e]), []).append(e)
        state["upto"] = n
        ends = idx.get(tuple(tokens[n - mm :]))
        if not ends:
            return []
        best_end, best_score = -1, None
        for e in reversed(ends[-self._MAX_CANDIDATES :]):
            ext = mm
            while ext < self.max_match and e > ext and tokens[e - ext - 1] == tokens[n - ext - 1]:
                ext += 1
            score = (ext, e + k <= n)
            if best_score is None or score > best_score:
                best_score, best_end = score, e
        return list(tokens[best_end : best_end + k])
