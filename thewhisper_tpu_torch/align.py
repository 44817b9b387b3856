"""Word-timestamp alignment: z-norm, median filter and DTW (the port's own
copy of thewhisper_tpu's ``align.py``).

The decode loop's alignment-head cross-attention matrix is z-normalized
over token positions, median-filtered over encoder frames, averaged over
heads and aligned with monotonic DTW; per-token timestamps are the time
indices at text-index jumps, scaled by ``TIME_PRECISION`` (0.02 s).

Host work, once per audio window (at most 448 x 1500 a sample). DTW runs
in the C++ host runtime (``native_lib.dtw_path_native``), as the JAX
package's does; ``dtw_path_plain``, the numpy anti-diagonal sweep (the
O(S*T) recurrence as about S + T vectorized steps), gives the same paths
and is what tests hold it against.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from thewhisper_tpu_torch.config import TIME_PRECISION
from thewhisper_tpu_torch.native_lib import dtw_path_native

# Median-of-7 selection network (Paeth): 13 vectorized compare-exchanges
# leave the median in column 3, far faster than np.median over a strided
# window view on the per-window alignment shape.
_MEDIAN7_PAIRS = ((0, 5), (0, 3), (1, 6), (2, 4), (0, 1), (3, 5), (2, 6),
                  (2, 3), (3, 6), (4, 5), (1, 4), (1, 3), (3, 4))


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Sliding median over the last axis with reflect padding.

    Matches HF ``_median_filter`` (torch unfold + median over a
    reflect-padded window); identity when width <= 1 or the axis is too
    short to reflect-pad (HF skips only when T <= width // 2: short windows
    with width // 2 < T < width are filtered).
    """
    if width <= 1 or x.shape[-1] <= width // 2:
        return x
    half = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)], mode="reflect")
    if width == 7:       # Whisper's default alignment filter width
        # Row-blocked so the 7 shifted columns stay cache-resident.
        t_out = x.shape[-1]
        flat = padded.reshape(-1, padded.shape[-1])
        out = np.empty(x.shape, x.dtype)
        oflat = out.reshape(-1, t_out)
        for r0 in range(0, flat.shape[0], 8):
            sl = flat[r0: r0 + 8]
            cols = [sl[:, i: i + t_out].copy() for i in range(7)]
            for a, b in _MEDIAN7_PAIRS:
                lo = np.minimum(cols[a], cols[b])
                cols[b] = np.maximum(cols[a], cols[b])
                cols[a] = lo
            oflat[r0: r0 + 8] = cols[3]
        return out
    windows = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1))
    if width % 2:        # exact kth selection beats a full median sort
        return np.partition(windows, width // 2, axis=-1)[..., width // 2]
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through a (S, T) cost matrix, in the host runtime.

    Allowed moves: diagonal (i-1,j-1), up (i-1,j), left (i,j-1). Returns the
    backtraced (text_indices, time_indices). Matches HF
    ``_dynamic_time_warping`` on the negative alignment matrix.
    """
    return dtw_path_native(cost)


def dtw_path_plain(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`dtw_path` in numpy: the anti-diagonal sweep."""
    s, t = cost.shape
    acc = np.full((s + 1, t + 1), np.inf, dtype=np.float64)
    acc[0, 0] = 0.0
    # trace codes: 0 = diagonal, 1 = up (advance text), 2 = left (advance time)
    trace = np.full((s + 1, t + 1), 2, dtype=np.int8)
    trace[:, 0] = 1

    # Anti-diagonal sweep: cells (i, j) with i + j = d depend only on
    # diagonals d-1 and d-2, so each diagonal is one vectorized update.
    cost64 = cost.astype(np.float64)
    for d in range(2, s + t + 1):
        i_lo = max(1, d - t)
        i_hi = min(s, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        c_diag = acc[i - 1, j - 1]
        c_up = acc[i - 1, j]
        c_left = acc[i, j - 1]
        # HF's tie cascade (strict <): a tie falls through to LEFT even
        # when left is not the minimum, for timestamp parity on ties.
        stacked = np.stack([c_diag, c_up, c_left])
        pick_diag = (c_diag < c_up) & (c_diag < c_left)
        pick_up = (c_up < c_diag) & (c_up < c_left)
        choice = np.where(pick_diag, 0, np.where(pick_up, 1, 2))
        acc[i, j] = cost64[i - 1, j - 1] + stacked[choice, np.arange(len(i))]
        trace[i, j] = choice

    # Backtrace from (s, t).
    i, j = s, t
    text_indices, time_indices = [], []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        move = trace[i, j]
        if move == 0:
            i -= 1
            j -= 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
    return (
        np.array(text_indices[::-1], dtype=np.int64),
        np.array(time_indices[::-1], dtype=np.int64),
    )


def token_timestamps_from_alignment(
    align: np.ndarray,                 # (B, A, S_rows, T_enc) f32
    num_rows: np.ndarray,              # (B,) rows actually populated
    num_frames=None,                   # mel frames of real audio: int | (B,) | None
    median_filter_width: int = 7,
    time_precision: float = TIME_PRECISION,
) -> np.ndarray:
    """Per-token timestamps (B, S_rows + 1) in seconds.

    ``timestamps[b, i+1]`` is the jump time of token row i, reproducing
    ``_extract_token_timestamps`` (z-norm over tokens -> median filter over
    frames -> head mean -> DTW over the negative matrix -> jump times).
    ``num_frames`` crops padded encoder frames before DTW (``num_frames//2``
    encoder positions), per sample when given as an array.
    """
    b, a, s_rows, t_enc = align.shape
    out = np.zeros((b, s_rows + 1), dtype=np.float32)
    frames = np.broadcast_to(
        np.asarray(2 * t_enc if num_frames is None else num_frames), (b,))

    for bi in range(b):
        rows = int(num_rows[bi])
        if rows <= 0:
            continue
        t_crop = min(t_enc, int(frames[bi]) // 2)
        # float32 like HF (torch weights are f32, std unbiased=False).
        m = align[bi, :, :rows, :t_crop].astype(np.float32)   # (A, S, T)
        std = m.std(axis=-2, keepdims=True)
        mean = m.mean(axis=-2, keepdims=True)
        m = (m - mean) / np.where(std == 0, 1.0, std)
        m = median_filter(m, median_filter_width)
        matrix = m.mean(axis=0)                                # (S, T)
        text_idx, time_idx = dtw_path(-matrix)
        jumps = np.pad(np.diff(text_idx), (1, 0), constant_values=1).astype(bool)
        jump_times = time_idx[jumps] * time_precision
        out[bi, 1: 1 + len(jump_times)] = jump_times
    return out
