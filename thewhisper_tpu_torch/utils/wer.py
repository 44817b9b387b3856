"""Word/character error rate and alignment (no jiwer/evaluate dependency).

The port's own copy of thewhisper_tpu's ``utils/wer.py``: a Levenshtein
implementation returning the numbers ``evaluate``'s WER/CER give, plus the
aligned operation list an error analysis needs. ``edit_stats`` runs in the
C++ host runtime (tokens interned to int32 ids); ``edit_stats_plain`` is
its numpy version, which tests hold it against.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from thewhisper_tpu_torch.native_lib import edit_stats_native


def edit_stats(ref: Sequence, hyp: Sequence) -> Dict[str, int]:
    """Levenshtein S/D/I counts between two token sequences."""
    vocab: Dict = {}

    def intern(seq):
        out = np.empty(len(seq), dtype=np.int32)
        for i, tok in enumerate(seq):
            out[i] = vocab.setdefault(tok, len(vocab))
        return out

    return edit_stats_native(intern(ref), intern(hyp))


def _cost_matrix(ref: Sequence, hyp: Sequence) -> np.ndarray:
    n, m = len(ref), len(hyp)
    cost = np.zeros((n + 1, m + 1), dtype=np.int32)
    cost[:, 0] = np.arange(n + 1)
    cost[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cost[i, j] = min(
                cost[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                cost[i - 1, j] + 1,
                cost[i, j - 1] + 1,
            )
    return cost


def _backtrace(cost: np.ndarray, ref: Sequence, hyp: Sequence
               ) -> List[Tuple[str, str, str]]:
    """Aligned ops, last first; ties prefer the diagonal, then deletion."""
    ops: List[Tuple[str, str, str]] = []
    i, j = len(ref), len(hyp)
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + (
                ref[i - 1] != hyp[j - 1]):
            op = "sub" if ref[i - 1] != hyp[j - 1] else "equal"
            ops.append((op, ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and cost[i, j] == cost[i - 1, j] + 1:
            ops.append(("del", ref[i - 1], ""))
            i -= 1
        else:
            ops.append(("ins", "", hyp[j - 1]))
            j -= 1
    return ops


def edit_stats_plain(ref: Sequence, hyp: Sequence) -> Dict[str, int]:
    """:func:`edit_stats` in numpy."""
    ops = _backtrace(_cost_matrix(ref, hyp), ref, hyp)
    count = {op: sum(o[0] == op for o in ops)
             for op in ("sub", "del", "ins", "equal")}
    return {"subs": count["sub"], "dels": count["del"], "ins": count["ins"],
            "hits": count["equal"], "ref_len": len(ref), "hyp_len": len(hyp),
            "errors": count["sub"] + count["del"] + count["ins"]}


def wer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Corpus WER over whitespace-tokenized texts (matches evaluate's wer)."""
    total_err = 0
    total_ref = 0
    for ref, hyp in zip(references, hypotheses):
        st = edit_stats(ref.split(), hyp.split())
        total_err += st["errors"]
        total_ref += st["ref_len"]
    return total_err / max(total_ref, 1)


def cer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Corpus CER over characters."""
    total_err = 0
    total_ref = 0
    for ref, hyp in zip(references, hypotheses):
        st = edit_stats(list(ref), list(hyp))
        total_err += st["errors"]
        total_ref += st["ref_len"]
    return total_err / max(total_ref, 1)


def align_words(ref: Sequence[str], hyp: Sequence[str]
                ) -> List[Tuple[str, str, str]]:
    """Aligned ops: (op, ref_word, hyp_word) with op in equal|sub|del|ins.

    The jiwer-style alignment a post-correction analysis consumes.
    """
    return _backtrace(_cost_matrix(ref, hyp), ref, hyp)[::-1]
