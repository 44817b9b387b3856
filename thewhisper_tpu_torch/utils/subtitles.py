"""Subtitle export: ``{"text","chunks"}`` pipeline output -> SRT / WebVTT.

The port's own copy of thewhisper_tpu's ``utils/subtitles.py``, the tail
of the offline CLI (``run_asr.py --srt``). Words are grouped into caption
cues by pause, length, and duration limits — the same segmentation
heuristics subtitle tooling uses — with open word ends clamped forward.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


def _fmt_ts(seconds: float, sep: str) -> str:
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def group_cues(
    chunks: Sequence[Dict[str, Any]],
    max_chars: int = 42,
    max_duration_s: float = 6.0,
    max_pause_s: float = 0.8,
) -> List[Dict[str, Any]]:
    """Word chunks -> caption cues ``{"start", "end", "text"}``.

    A cue breaks at a pause > ``max_pause_s``, when its text would exceed
    ``max_chars`` (the common two-line broadcast limit is 2 x 42), or when
    it would span more than ``max_duration_s``. A missing word end (the
    pipeline's open last token) borrows the next word's start, else +0.5 s.
    """
    cues: List[Dict[str, Any]] = []
    cur_words: List[str] = []
    cur_start: Optional[float] = None
    cur_end = 0.0

    def flush():
        nonlocal cur_words, cur_start
        if cur_words:
            cues.append({"start": cur_start, "end": cur_end,
                         "text": "".join(cur_words).strip()})
        cur_words, cur_start = [], None

    chunks = [c for c in chunks if c.get("timestamp")
              and c["timestamp"][0] is not None]
    for i, c in enumerate(chunks):
        start, end = c["timestamp"]
        if end is None:
            nxt = chunks[i + 1]["timestamp"][0] if i + 1 < len(chunks) else None
            end = nxt if nxt is not None else start + 0.5
        text = c["text"]
        if cur_words:
            pause = start - cur_end
            too_long = (len("".join(cur_words)) + len(text) > max_chars
                        or end - cur_start > max_duration_s)
            if pause > max_pause_s or too_long:
                flush()
        if cur_start is None:
            cur_start = start
        cur_words.append(text)
        cur_end = max(cur_end, end)
    flush()
    return cues


def to_srt(chunks: Sequence[Dict[str, Any]], **group_kwargs) -> str:
    cues = group_cues(chunks, **group_kwargs)
    blocks = [
        f"{i + 1}\n{_fmt_ts(c['start'], ',')} --> {_fmt_ts(c['end'], ',')}\n"
        f"{c['text']}\n"
        for i, c in enumerate(cues)
    ]
    return "\n".join(blocks)


def to_vtt(chunks: Sequence[Dict[str, Any]], **group_kwargs) -> str:
    cues = group_cues(chunks, **group_kwargs)
    blocks = [
        f"{_fmt_ts(c['start'], '.')} --> {_fmt_ts(c['end'], '.')}\n"
        f"{c['text']}\n"
        for c in cues
    ]
    return "WEBVTT\n\n" + "\n".join(blocks)


def write_subtitles(path: str, chunks: Sequence[Dict[str, Any]],
                    **group_kwargs) -> str:
    """Write SRT or VTT depending on the file extension; returns path."""
    if path.endswith(".vtt"):
        content = to_vtt(chunks, **group_kwargs)
    elif path.endswith(".srt"):
        content = to_srt(chunks, **group_kwargs)
    else:
        raise ValueError("subtitle path must end in .srt or .vtt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(content)
    return path
