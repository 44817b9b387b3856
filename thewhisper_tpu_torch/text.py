"""Token -> word grouping and overlap-window merging (the port's own copy
of thewhisper_tpu's ``text.py``).

Behavioral parity targets:

- ``combine_tokens_into_words``: HF ``_combine_tokens_into_words``
  (tokenization_whisper.py) — unicode-safe token splitting, space/punctuation
  word assembly, punctuation merging.
- ``find_longest_common_sequence``: the reference's timestamp-aware LCS
  (``thestage_speechkit/__init__.py:5-134``): sliding-window alignment
  scoring ``matches/i + i/1e4`` where a token match only counts if the two
  tokens' timestamps are ordered; overlap resolved by trusting the left
  window before the overlap midpoint and the right window after.

Both are pure Python on host data: they run once per audio window, not per
token.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

# Languages written without spaces: group purely on unicode boundaries.
NO_SPACE_LANGUAGES = {"zh", "ja", "th", "lo", "my", "yue",
                      "chinese", "japanese", "thai", "lao", "myanmar", "cantonese"}

PREPEND_PUNCTUATIONS = "\"'“¡¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"
_MID_WORD_PUNCT = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"

DecodeFn = Callable[[Sequence[int]], str]


def split_tokens_on_unicode(decode: DecodeFn, tokens: Sequence[int]):
    """Split at positions where the accumulated tokens decode to valid text.

    BPE tokens can end mid-UTF-8-codepoint; a split point is valid when the
    decoded prefix has no replacement char (or the full decode has one at the
    same offset, i.e. it is genuinely in the data).
    """
    full = decode(tokens)
    repl = "�"
    words, word_tokens, token_indices = [], [], []
    cur_toks: List[int] = []
    cur_idx: List[int] = []
    offset = 0
    for i, tok in enumerate(tokens):
        cur_toks.append(int(tok))
        cur_idx.append(i)
        decoded = decode(cur_toks)
        if repl not in decoded or (
            offset + decoded.index(repl) < len(full)
            and full[offset + decoded.index(repl)] == repl
        ):
            words.append(decoded)
            word_tokens.append(cur_toks)
            token_indices.append(cur_idx)
            cur_toks, cur_idx = [], []
            offset += len(decoded)
    return words, word_tokens, token_indices


def _split_tokens_on_spaces(decode: DecodeFn, tokens: Sequence[int], special_id: int):
    subwords, sub_tokens, sub_indices = split_tokens_on_unicode(decode, tokens)
    words: List[str] = []
    word_tokens: List[List[int]] = []
    token_indices: List[List[int]] = []
    for sw, st, si in zip(subwords, sub_tokens, sub_indices):
        is_special = st[0] >= special_id
        with_space = sw.startswith(" ")
        is_punct = sw.strip() in _MID_WORD_PUNCT
        if is_special or with_space or is_punct or not words:
            words.append(sw)
            word_tokens.append(st)
            token_indices.append(si)
        else:
            words[-1] += sw
            word_tokens[-1].extend(st)
            token_indices[-1].extend(si)
    return words, word_tokens, token_indices


def _merge_punctuations(words, tokens, indices,
                        prepended=PREPEND_PUNCTUATIONS,
                        appended=APPEND_PUNCTUATIONS) -> None:
    # Attach opening punctuation to the following word.
    i, j = len(words) - 2, len(words) - 1
    while i >= 0:
        if words[i].startswith(" ") and words[i].strip() in prepended:
            words[j] = words[i] + words[j]
            tokens[j] = tokens[i] + tokens[j]
            indices[j] = indices[i] + indices[j]
            words[i], tokens[i], indices[i] = "", [], []
        else:
            j = i
        i -= 1
    # Attach closing punctuation to the preceding word.
    i, j = 0, 1
    while j < len(words):
        if not words[i].endswith(" ") and words[j] in appended:
            words[i] += words[j]
            tokens[i] += tokens[j]
            indices[i] += indices[j]
            words[j], tokens[j], indices[j] = "", [], []
        else:
            i = j
        j += 1
    words[:] = [w for w in words if w]
    tokens[:] = [t for t in tokens if t]
    indices[:] = [x for x in indices if x]


def combine_tokens_into_words(
    decode: DecodeFn,
    tokens: Sequence[int],
    language: Optional[str] = None,
    special_id: int = 50257,
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
):
    """Group a token sequence into words.

    Returns (words, word_tokens, token_indices) — same contract as HF's
    ``_combine_tokens_into_words``.
    """
    lang = (language or "english").lower()
    if lang in NO_SPACE_LANGUAGES:
        words, word_tokens, token_indices = split_tokens_on_unicode(decode, tokens)
    else:
        words, word_tokens, token_indices = _split_tokens_on_spaces(
            decode, tokens, special_id)
    _merge_punctuations(words, word_tokens, token_indices,
                        prepend_punctuations, append_punctuations)
    return words, word_tokens, token_indices


# ---------------------------------------------------------------------------
# Overlap-window merge
# ---------------------------------------------------------------------------

Timestamp = Tuple[Optional[float], Optional[float]]


def _ts_ordered(left: Timestamp, right: Timestamp) -> bool:
    # A match across windows counts only when timestamps are consistent:
    # missing end on the left always qualifies, else ordering. The right
    # end may ALSO be None (the last kept token of a window) — with equal
    # starts, bare tuple comparison would reach `float <= None` and raise
    # (latent in the reference monkey-patch too); treat a missing right
    # end as unbounded.
    if left[1] is None:
        return True
    if left[0] != right[0]:
        return left[0] < right[0]
    return right[1] is None or left[1] <= right[1]


def find_longest_common_sequence(
    sequences: Sequence[Sequence[int]],
    token_timestamp_sequences: Optional[Sequence[Sequence[Timestamp]]] = None,
):
    """Merge overlapping-window token sequences left to right.

    For each adjacent pair, every sliding alignment of the right sequence
    against the tail of the left is scored by ``matches / overlap + eps``
    with ``eps = overlap / 10000`` breaking ties toward longer overlaps;
    a position match requires equal tokens (and ordered timestamps when
    provided, needing at least 2 matches). The winning overlap is split at
    its midpoint: left text is trusted before it, right text after.
    """
    use_ts = token_timestamp_sequences is not None
    left = list(sequences[0])
    left_ts = list(token_timestamp_sequences[0]) if use_ts else []
    total: List[int] = []
    total_ts: List[Timestamp] = []

    for si in range(1, len(sequences)):
        right = list(sequences[si])
        right_ts = list(token_timestamp_sequences[si]) if use_ts else []
        ll, rl = len(left), len(right)

        best_score = 0.0
        best = (ll, ll, 0, 0)
        for i in range(1, ll + rl):
            eps = i / 10000.0
            l_start, l_stop = max(0, ll - i), min(ll, ll + rl - i)
            r_start, r_stop = max(0, i - ll), min(rl, i)
            matches = 0
            for k in range(l_stop - l_start):
                if left[l_start + k] == right[r_start + k] and (
                    not use_ts
                    or _ts_ordered(left_ts[l_start + k], right_ts[r_start + k])
                ):
                    matches += 1
            score = matches / i + eps
            if matches > 1 and score > best_score:
                best_score = score
                best = (l_start, l_stop, r_start, r_stop)

        l_start, l_stop, r_start, r_stop = best
        l_mid = (l_stop + l_start) // 2
        r_mid = (r_stop + r_start) // 2
        total.extend(left[:l_mid])
        left = right[r_mid:]
        if use_ts:
            total_ts.extend(left_ts[:l_mid])
            left_ts = right_ts[r_mid:]

    total.extend(left)
    if not use_ts:
        return total
    total_ts.extend(left_ts)
    return total, total_ts
