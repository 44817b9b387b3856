"""The algorithm of the K3/K4 engine (csrc/mega_common.cuh), emulated in
torch on the CPU: no GPU needed.

- The split attention: each (head, chunk) item keeps its max, sum and
  un-normalised output for every window row, the next phase combines the
  chunks of a head (the flash-decoding combine), and the alignment heads'
  raw scores are normalised once the combine gives the head's max and sum.
  At f32 it equals the plain attention of ``ops.mega_step._rows_plain`` to
  1e-6 relative, for chunk lengths that do and do not divide T = 1500 and
  the slots a window sees, at W = 1 and W = 5 with the causal edge.
- The partition the wrapper and the kernel use: rows of every matrix by
  block, attention items by (head, chunk), each row and item exactly once,
  blocks at most one row or item apart.
- The consumer's operand plumbing: the int8-to-bf16 conversion is exact for
  every byte, and the mma fragment slots of a 64-column block cover its
  columns once.
"""

import numpy as np
import pytest
import torch

from thewhisper_tpu_torch.ops import mega_step as tm

from _torch_tiny import one_cpu_thread  # noqa: F401

H, DH = 20, 64


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _plain_self(q, k, v, pos):
    """_rows_plain's self-attention of the W window rows (q (W, H, dh)
    unscaled, k/v (H, n, dh), n = pos + W): row r sees slots [0, pos + r]."""
    w, n = q.shape[0], k.shape[1]
    causal = torch.arange(n)[None, :] <= pos + torch.arange(w)[:, None]
    logits = torch.einsum("whd,hsd->hws", q * DH ** -0.5, k)
    p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("hws,hsd->whd", p, v)


def _plain_cross(q, k, v):
    """_rows_plain's cross-attention (q already scaled, (W, H, dh)): the
    probabilities (W, H, T) and the output before the V scale."""
    p = torch.softmax(torch.einsum("whd,htd->wht", q, k), dim=-1)
    return p, torch.einsum("wht,htd->whd", p, v)


def _split(q, k, v, chunk, visible):
    """The engine's attention: scores of each chunk (-inf where a row may
    not see a key), the chunk's max m, sum l and un-normalised output o;
    then the combine. Returns (output (W, H, dh), the probabilities
    normalised afterwards from the raw scores, (W, H, n))."""
    n = k.shape[1]
    parts, raw = [], []
    for c0 in range(0, n, chunk):
        s = torch.einsum("whd,htd->wht", q, k[:, c0:c0 + chunk])
        s = s.masked_fill(~visible[:, None, c0:c0 + chunk], float("-inf"))
        m = s.amax(-1)
        e = torch.where(torch.isfinite(m)[..., None], torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        parts.append((m, e.sum(-1), torch.einsum("wht,htd->whd", e, v[:, c0:c0 + chunk])))
        raw.append(s)
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    weights = [torch.where(torch.isfinite(m), torch.exp(m - big_m), torch.zeros_like(m))
               for m, _, _ in parts]
    z = sum(l * wt for (_, l, _), wt in zip(parts, weights))
    out = sum(o * wt[..., None] for (_, _, o), wt in zip(parts, weights)) / z[..., None]
    probs = torch.exp(torch.cat(raw, -1) - big_m[..., None]) * (1.0 / z[..., None])
    return out, probs


@pytest.mark.parametrize("chunk", [64, 100, 250, 256, 300, 336, 1499, 1500])
@pytest.mark.parametrize("w", [1, 5])
def test_split_cross_attention_equals_plain(chunk, w):
    rng = np.random.default_rng(chunk * 10 + w)
    t = 1500
    q = torch.from_numpy(rng.standard_normal((w, H, DH)).astype(np.float32)) * 0.05
    k = torch.from_numpy(rng.integers(-127, 128, (H, t, DH)).astype(np.float32))
    v = torch.from_numpy(rng.integers(-127, 128, (H, t, DH)).astype(np.float32))
    p_ref, out_ref = _plain_cross(q, k, v)
    out, probs = _split(q, k, v, chunk, torch.ones(w, t, dtype=torch.bool))
    assert _rel(out, out_ref) <= 1e-6
    # The alignment heads' probabilities, normalised after the combine.
    assert _rel(probs, p_ref) <= 1e-6


@pytest.mark.parametrize("chunk", [1, 5, 12, 13, 36, 72])
@pytest.mark.parametrize("w", [1, 5])
def test_split_self_attention_equals_plain(chunk, w):
    """Slots [0, pos + W) at pos = 67: the causal edge masks a row's later
    slots, and with small chunks whole chunks (m = -inf, l = 0) for the
    first rows."""
    rng = np.random.default_rng(chunk + 100 * w)
    pos = 72 - w
    n = pos + w
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((w, H, DH), (H, n, DH), (H, n, DH)))
    visible = torch.arange(n)[None, :] <= pos + torch.arange(w)[:, None]
    out, _ = _split(q * DH ** -0.5, k, v, chunk, visible)
    assert _rel(out, _plain_self(q, k, v, pos)) <= 1e-6


def test_split_attention_at_the_wrappers_chunks():
    """The chunk lengths the wrapper picks for a 132-SM card (and for a few
    other block counts) at T = 1500 and a window of 5 at pos 67."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((5, H, DH)).astype(np.float32)) * 0.05
    k, v = (torch.from_numpy(rng.integers(-127, 128, (H, 1500, DH)).astype(np.float32))
            for _ in range(2))
    _, out_ref = _plain_cross(q, k, v)
    for blocks in (132, 114, 78, 20, 7):
        chunk, count = tm.attention_chunks(1500, H, blocks)
        out, _ = _split(q, k, v, chunk, torch.ones(5, 1500, dtype=torch.bool))
        assert _rel(out, out_ref) <= 1e-6, blocks


@pytest.mark.parametrize("rows,blocks", [(3840, 132), (1280, 132), (5120, 132),
                                         (51866, 132), (1152, 132), (500, 132),
                                         (5, 132), (3840, 7)])
def test_row_split_covers_every_row_once(rows, blocks):
    seen = np.zeros(rows, np.int64)
    sizes = []
    for b in range(blocks):
        lo, hi = tm.row_range(b, blocks, rows)
        seen[lo:hi] += 1
        sizes.append(hi - lo)
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n,heads,blocks", [(1500, 20, 132), (1501, 20, 132),
                                            (68, 20, 132), (72, 20, 132),
                                            (96, 6, 132), (1500, 6, 132),
                                            (1500, 20, 16), (4000, 20, 132),
                                            (1, 20, 132)])
def test_attention_items_cover_every_key_once(n, heads, blocks):
    chunk, count = tm.attention_chunks(n, heads, blocks)
    assert 1 <= chunk <= tm.MAX_CHUNK and chunk * count >= n > chunk * (count - 1)
    items = heads * count
    # One wave wherever the chunk bound allows it.
    if -(-n // max(1, blocks // heads)) <= tm.MAX_CHUNK:
        assert items <= max(blocks, heads)
    keys = np.zeros((heads, n), np.int64)
    per_block = []
    for b in range(blocks):
        mine = range(b, items, blocks)         # the kernel's item loop
        per_block.append(len(mine))
        for it in mine:
            h, c = divmod(it, count)
            keys[h, c * chunk:min(n, (c + 1) * chunk)] += 1
    assert (keys == 1).all()
    assert max(per_block) - min(per_block) <= 1


def test_self_attention_chunks_hold_a_minimum():
    """The wrapper's self-attention chunks: one item a head up to
    SELF_MIN_CHUNK slots, split beyond it."""
    assert tm.attention_chunks(68, 20, 132, tm.SELF_MIN_CHUNK) == (128, 1)
    assert tm.attention_chunks(128, 20, 132, tm.SELF_MIN_CHUNK) == (128, 1)
    assert tm.attention_chunks(228, 20, 132, tm.SELF_MIN_CHUNK) == (128, 2)
    length, count = tm.attention_chunks(448, 6, 132, tm.SELF_MIN_CHUNK)
    assert length * count >= 448 and length >= tm.SELF_MIN_CHUNK


def test_work_bytes_holds_every_part():
    """The scratch of a K4 launch at large-v3 (W = 16) on 132 SMs: the
    counters, qkv, attention and hidden rows in bf16, the cross query and
    both chunk partials in f32."""
    sc, sn = tm.attention_chunks(84, 20, 132)
    cc, cn = tm.attention_chunks(1500, 20, 132)
    got = tm.work_bytes(32, 16, 1280, 5120, 20, sn, cn, 0, 1500)
    counters = 4 * (1 + 2 * 32 * 20) + 12            # to a multiple of 16
    assert got == (counters + 2 * 16 * (4 * 1280 + 5120) + 4 * 16 * 1280
                   + 4 * 68 * 16 * 20 * (sn + cn) + 4 * 1500)


def _s8x4_to_bf16x2(word):
    """s8x4_to_bf16x2 of csrc/mega_common.cuh in numpy: each byte + 128 in
    the mantissa of 2**23, minus 2**23 + 128, the high halves packed."""
    u = np.uint32(word) ^ np.uint32(0x80808080)
    f = [(np.uint32(0x4B000000) | ((u >> np.uint32(8 * i)) & np.uint32(0xFF)))
         .view(np.float32) - np.float32(8388736.0) for i in range(4)]
    bits = [np.float32(x).view(np.uint32) >> np.uint32(16) for x in f]
    lo = bits[0] | (bits[1] << np.uint32(16))
    hi = bits[2] | (bits[3] << np.uint32(16))
    return lo, hi


def test_int8_to_bf16_is_exact_for_every_byte():
    for b in range(-128, 128):
        word = int(np.array([b, -b - 1 if b > -128 else 127, 0, b // 2],
                            np.int8).view(np.uint32)[0])
        lo, hi = _s8x4_to_bf16x2(word)
        halves = np.array([lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16], np.uint32)
        got = (halves << np.uint32(16)).view(np.float32)
        want = np.array([word], np.uint32).view(np.int8).astype(np.float32)
        np.testing.assert_array_equal(got, want)


def test_fragment_slots_cover_a_block_once():
    """Lane (g, t) of an m16n8k16 mma holds A and B slots {2t, 2t + 1,
    2t + 8, 2t + 9}; mma step jj of a 64-column block maps them to columns
    16t + 4jj + {0, 1, 2, 3}, alike in both operands. Over t and jj every
    column is used once, so the block's product is the plain one."""
    cols = []
    for jj in range(4):
        step = {}
        for t in range(4):
            for slot, col in zip((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9),
                                 range(16 * t + 4 * jj, 16 * t + 4 * jj + 4)):
                step[slot] = col
        assert sorted(step) == list(range(16))
        cols += step.values()
    assert sorted(cols) == list(range(64))
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (16, 64)).astype(np.float64)
    b = rng.standard_normal((64, 8))
    total = np.zeros((16, 8))
    for jj in range(4):
        for t in range(4):
            k = list(range(16 * t + 4 * jj, 16 * t + 4 * jj + 4))
            total += a[:, k] @ b[k]
    np.testing.assert_allclose(total, a @ b, rtol=1e-12)
