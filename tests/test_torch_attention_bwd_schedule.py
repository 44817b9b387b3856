"""The schedule of the bf16 route of K2-dkv and K2-dq
(csrc/encoder_attention_bwd.cu), emulated in torch on the CPU: no GPU needed.

A block holds 128 resident rows of one side, two consumer warpgroups of 64
(keys for dK/dV, queries for dQ), and walks 64-row tiles of the other side
that the producer streams through a ring; rows past S arrive as zeros. A
consumer computes its scores and dP as 64 x 64 tiles, P in the log2 domain
(exp2(s scale log2 e - lse log2 e)), rounds P (dV's A operand) and dS (dK's
or dQ's) to bf16 at the fragment points, sums in f32 and scales dK and dQ
by 1 / sqrt(dh) at the end. Queries past S have no lse or di: the kernel
takes lse as +inf (P = 0) and di as 0 there; keys >= valid_len get P = 0.

- The emulation equals ``encoder_attention_backward_plain`` in f32 to 1e-5
  relative L2, and in bf16 its distance from the f32 gradients is at most
  1.5x the plain bf16 version's (the card tests' bound), at S = 1, 77, 130,
  500 and 1500, valid_len None, 30 and 1100.
- Leaving out either guard past S, with lse and di followed by NaN in
  memory (as the card test lays them out), puts NaN into dK.
- The producer's walk and the consumers' walk, with the kernel's own
  mbarrier parities, meet in every interleaving tried: each consumer takes
  every stage the producer opens, reads each tile only after it landed,
  and no stage is refilled before both consumers released it; at arm A's
  and arm B's shapes, for both kernels.
"""

import math
import random
import re
from pathlib import Path

import pytest
import torch

from thewhisper_tpu_torch.ops import attention as ta

from _torch_tiny import one_cpu_thread  # noqa: F401

SRC = (Path(ta.__file__).resolve().parents[1] / "csrc" / "encoder_attention_bwd.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


ROWS, CONSUMERS, STAGES = _const("kTcRows"), _const("kTcConsumers"), _const("kTcStages")
BLOCK = ROWS * CONSUMERS
LOG2E = 1.4426950408889634
SCALE = 0.125
SCALE_LOG2 = torch.tensor(SCALE * LOG2E, dtype=torch.float32)


def _rounder(dtype):
    if dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def _pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, H, S, 64) zero-filled to ``rows`` rows: TMA's rows past S."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[2]))


def _flat(x: torch.Tensor) -> torch.Tensor:
    """A (B, H, S) f32 row buffer followed by NaN: what lies past it."""
    return torch.cat([x.flatten(), torch.full((BLOCK,), float("nan"))])


def _guarded(flat, bh0, cols, s, fill, guard=True):
    """flat[bh S + col] for the (B, H) rows and the tile's columns, ``fill``
    past S (or, without the guard, whatever lies there)."""
    got = flat[bh0[..., None] + cols]
    return torch.where(cols < s, got, torch.tensor(fill)) if guard else got


def emulate_dkv(q, k, v, do, lse, di, valid, dtype, guard_lse=True, guard_di=True):
    """dK, dV of the dK/dV kernel's walk. q, do: (B, H, S_q, 64) and k, v:
    (B, H, S_k, 64) f32 holding the operand values; lse, di: (B, H, S_q)
    f32."""
    b, h, s, _ = q.shape
    s_k = k.shape[2]
    rnd = _rounder(dtype)
    n_tiles = math.ceil(s / ROWS)
    qp, dop = _pad(q, n_tiles * ROWS), _pad(do, n_tiles * ROWS)
    kp, vp = (_pad(x, math.ceil(s_k / BLOCK) * BLOCK) for x in (k, v))
    lse_f, di_f = _flat(lse), _flat(di)
    bh0 = torch.arange(b * h).view(b, h) * s
    dk, dv = torch.zeros(b, h, s_k, 64), torch.zeros(b, h, s_k, 64)
    for row0 in range(0, s_k, BLOCK):
        if row0 >= valid:
            continue                                   # a block of zeros
        for wg in range(CONSUMERS):
            keys = torch.arange(row0 + wg * ROWS, row0 + (wg + 1) * ROWS)
            kt, vt = kp[:, :, keys], vp[:, :, keys]
            acc_k, acc_v = torch.zeros(b, h, ROWS, 64), torch.zeros(b, h, ROWS, 64)
            for t in range(n_tiles):
                cols = torch.arange(t * ROWS, (t + 1) * ROWS)
                qt, dot = qp[:, :, cols], dop[:, :, cols]
                s_t = kt @ qt.transpose(-1, -2)        # S^T: keys x queries
                dp_t = vt @ dot.transpose(-1, -2)
                lse2 = _guarded(lse_f, bh0, cols, s, math.inf, guard_lse) * LOG2E
                di_c = _guarded(di_f, bh0, cols, s, 0.0, guard_di)
                p = torch.exp2(s_t * SCALE_LOG2 - lse2[:, :, None, :])
                p = torch.where((keys < valid)[:, None], p, torch.tensor(0.0))
                acc_v += rnd(p) @ dot
                acc_k += rnd(p * (dp_t - di_c[:, :, None, :])) @ qt
            keep = keys < s_k
            dk[:, :, keys[keep]] = (acc_k * SCALE)[:, :, keep]
            dv[:, :, keys[keep]] = acc_v[:, :, keep]
    return dk, dv


def emulate_dq(q, k, v, do, lse, di, valid, dtype, mask_keys=True):
    """dQ of the dQ kernel's walk (arguments as ``emulate_dkv``)."""
    b, h, s, _ = q.shape
    s_k = k.shape[2]
    rnd = _rounder(dtype)
    n_tiles = math.ceil(valid / ROWS)
    kp, vp = (_pad(x, max(s_k, n_tiles * ROWS)) for x in (k, v))
    padded = math.ceil(s / BLOCK) * BLOCK
    qp, dop = _pad(q, padded), _pad(do, padded)
    lse_f, di_f = _flat(lse), _flat(di)
    bh0 = torch.arange(b * h).view(b, h) * s
    dq = torch.zeros(b, h, s, 64)
    for row0 in range(0, s, BLOCK):
        for wg in range(CONSUMERS):
            rows = torch.arange(row0 + wg * ROWS, row0 + (wg + 1) * ROWS)
            qt, dot = qp[:, :, rows], dop[:, :, rows]
            lse2 = _guarded(lse_f, bh0, rows, s, math.inf) * LOG2E
            di_r = _guarded(di_f, bh0, rows, s, 0.0)
            acc = torch.zeros(b, h, ROWS, 64)
            for t in range(n_tiles):
                keys = torch.arange(t * ROWS, (t + 1) * ROWS)
                kt, vt = kp[:, :, keys], vp[:, :, keys]
                p = torch.exp2(qt @ kt.transpose(-1, -2) * SCALE_LOG2 - lse2[..., None])
                if mask_keys:
                    p = torch.where(keys < valid, p, torch.tensor(0.0))
                dp = dot @ vt.transpose(-1, -2)
                acc += rnd(p * (dp - di_r[..., None])) @ kt
            keep = rows < s
            dq[:, :, rows[keep]] = (acc * SCALE)[:, :, keep]
    return dq


def _case(b, h, s, valid_len, dtype, seed=0, s_q=None):
    """Seeded q, k, v, dO and the forward's out and lse: S keys and, with
    ``s_q``, that many queries (the sequence-parallel encoder's)."""
    g = torch.Generator().manual_seed(seed)
    rows = (s_q or s, s, s, s_q or s)
    q, k, v, do = (torch.randn(b, n, h, 64, generator=g).to(dtype) for n in rows)
    out, lse = ta.encoder_attention_residuals(q, k, v, valid_len)
    return q, k, v, do, out, lse


def _emulate(q, k, v, do, out, lse, valid_len, **kw):
    """(dq, dk, dv) of both kernels, (B, S, H, 64) in the operand type."""
    dtype, valid = q.dtype, valid_len or k.shape[1]
    tq, tk, tv, tdo = (x.transpose(1, 2).float() for x in (q, k, v, do))
    di = (out.float() * do.float()).sum(-1).transpose(1, 2)
    dk, dv = emulate_dkv(tq, tk, tv, tdo, lse, di, valid, dtype, **kw)
    dq = emulate_dq(tq, tk, tv, tdo, lse, di, valid, dtype)
    return tuple(x.transpose(1, 2).to(dtype) for x in (dq, dk, dv))


def _l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


CASES = [(1, None), (77, None), (130, None), (500, None), (77, 30), (130, 30),
         (500, 30), (1500, 1100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,valid_len", CASES)
def test_schedule_matches_plain(s, valid_len, dtype):
    b = 1 if s == 1500 else 2
    q, k, v, do, out, lse = _case(b, 2, s, valid_len, dtype, seed=s)
    got = _emulate(q, k, v, do, out, lse, valid_len)
    plain = ta.encoder_attention_backward_plain(q, k, v, out, lse, do, valid_len)
    if valid_len is not None:
        assert not got[1][:, valid_len:].any() and not got[2][:, valid_len:].any()
    if s == 1:
        # One key, weight 1: dV = dO, and dQ and dK vanish up to the
        # rounding of dO v^T - di, which a relative bound cannot hold.
        torch.testing.assert_close(got[2].float(), do.float(), atol=0, rtol=1e-5)
        assert max(g_.float().abs().max().item() for g_ in got[:2]) <= 1e-3
        return
    if dtype == torch.float32:
        for name, g_, p_ in zip("qkv", got, plain):
            assert _l2(g_, p_) <= 1e-5, name
        return
    f = [x.float() for x in (q, k, v, do)]
    out32, lse32 = ta.encoder_attention_residuals(*f[:3], valid_len)
    ref = ta.encoder_attention_backward_plain(*f[:3], out32, lse32, f[3], valid_len)
    for name, g_, p_, r_ in zip("qkv", got, plain, ref):
        assert _l2(g_, r_) <= 1.5 * _l2(p_, r_), name


# (queries, keys, valid_len): a sequence-parallel rank's queries over the
# keys gathered from every rank (T = 50 at tp 4: blocks of 13, 52 keys),
# fewer queries than a key block, and more queries than keys.
SQ_CASES = [(13, 52, 50), (75, 150, 140), (188, 130, 100), (200, 77, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k,valid_len", SQ_CASES)
def test_schedule_with_other_query_and_key_counts_matches_plain(s_q, s_k,
                                                               valid_len, dtype):
    """S_q != S_k: the dK/dV grid over S_k key blocks streaming S_q
    queries (lse and di guarded past S_q), the dQ grid over S_q query
    blocks streaming keys below valid_len; pad keys get zero dK and dV."""
    q, k, v, do, out, lse = _case(2, 2, s_k, valid_len, dtype, seed=s_q, s_q=s_q)
    got = _emulate(q, k, v, do, out, lse, valid_len)
    plain = ta.encoder_attention_backward_plain(q, k, v, out, lse, do, valid_len)
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in plain]
    if valid_len is not None:
        assert not got[1][:, valid_len:].any() and not got[2][:, valid_len:].any()
    if dtype == torch.float32:
        for name, g_, p_ in zip("qkv", got, plain):
            assert _l2(g_, p_) <= 1e-5, name
        return
    f = [x.float() for x in (q, k, v, do)]
    out32, lse32 = ta.encoder_attention_residuals(*f[:3], valid_len)
    ref = ta.encoder_attention_backward_plain(*f[:3], out32, lse32, f[3], valid_len)
    for name, g_, p_, r_ in zip("qkv", got, plain, ref):
        assert _l2(g_, r_) <= 1.5 * _l2(p_, r_), name


@pytest.mark.parametrize("left_out", ["lse", "di"])
def test_leaving_out_a_guard_past_s_puts_nan_into_dk(left_out):
    """S = 77: the last (batch, head) row's second query tile reads 51
    columns past S, where memory holds NaN. With both guards dK is finite
    and equal to the plain version's; without the lse guard P is NaN there,
    and without the di guard dS = 0 (0 - NaN) is."""
    q, k, v, do, out, lse = _case(2, 2, 77, None, torch.float32, seed=3)
    tq, tk, tv, tdo = (x.transpose(1, 2).float() for x in (q, k, v, do))
    di = (out * do).sum(-1).transpose(1, 2)
    dk, _ = emulate_dkv(tq, tk, tv, tdo, lse, di, 77, torch.float32)
    plain = ta.encoder_attention_backward_plain(q, k, v, out, lse, do)[1]
    assert torch.isfinite(dk).all() and _l2(dk.transpose(1, 2), plain) <= 1e-5
    broken, _ = emulate_dkv(tq, tk, tv, tdo, lse, di, 77, torch.float32,
                            guard_lse=left_out != "lse", guard_di=left_out != "di")
    assert not torch.isfinite(broken[-1, -1]).all()


def test_the_kernel_waits_on_the_parities_walked_here():
    """The ring walks below use the kernel's own parity expressions."""
    assert "mbar_wait(&full[st], (t / kTcStages) & 1);" in SRC
    assert "mbar_wait(&empty[st], ((t / kTcStages) - 1) & 1);" in SRC
    assert "mbar_init(&empty[s], 128 * kTcConsumers);" in SRC


class Barrier:
    """An mbarrier: a phase completes after ``count`` arrivals;
    try_wait.parity(p) passes once the phase of parity p has completed,
    that is while the current phase's parity differs from p."""

    def __init__(self, count):
        self.count, self.pending, self.phases = count, count, 0

    def passes(self, parity):
        return (self.phases & 1) != parity

    def arrive(self, n=1):
        self.pending -= n
        if self.pending == 0:
            self.phases, self.pending = self.phases + 1, self.count


def _walk_block(n_tiles, rng):
    """One block's producer and consumers under a random interleaving, with
    the kernel's parities. Returns (stages opened, stages each consumer
    took)."""
    full = [Barrier(1) for _ in range(STAGES)]
    empty = [Barrier(128 * CONSUMERS) for _ in range(STAGES)]
    slot = [None] * STAGES        # the tile whose data a stage holds
    readers = [set() for _ in range(STAGES)]
    produced, taken = 0, [0] * CONSUMERS
    phase = [0] * CONSUMERS       # 0: wait for the tile, 1: release it

    def producer_step():
        nonlocal produced
        t, st = produced, produced % STAGES
        if t >= STAGES and not empty[st].passes(((t // STAGES) - 1) & 1):
            return False
        assert readers[st] in (set(), set(range(CONSUMERS))), "refilled while read"
        slot[st], readers[st] = t, set()
        full[st].arrive()         # expect_tx and the TMA bytes land
        produced += 1
        return True

    def consumer_step(c):
        t, st = taken[c], taken[c] % STAGES
        if phase[c] == 0:
            if not full[st].passes((t // STAGES) & 1):
                return False
            assert slot[st] == t, f"consumer {c} read tile {slot[st]} as tile {t}"
            readers[st].add(c)
            phase[c] = 1
        else:
            empty[st].arrive(128)
            phase[c], taken[c] = 0, t + 1
        return True

    while produced < n_tiles or min(taken) < n_tiles:
        movers = ([producer_step] if produced < n_tiles else []) + [
            (lambda c=c: consumer_step(c)) for c in range(CONSUMERS) if taken[c] < n_tiles]
        rng.shuffle(movers)
        assert any(m() for m in movers), "deadlock"
    return produced, taken


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("b,s,valid_len", [(8, 500, None), (4, 1500, None), (1, 1500, 1100)])
def test_producer_and_consumers_walk_the_same_stages(kernel, b, s, valid_len):
    """Stages the producer opens against those each consumer takes, summed
    over the grid (H = 20); dK/dV blocks past valid_len open none."""
    valid, rng = valid_len or s, random.Random(s)
    opened = taken = 0
    for row0 in range(0, s, BLOCK):
        n_tiles = (0 if row0 >= valid else math.ceil(s / ROWS)) if kernel == "dkv" \
            else math.ceil(valid / ROWS)
        for _ in range(3):        # interleavings of one block
            p, c = _walk_block(n_tiles, rng)
            assert c == [p] * CONSUMERS
        opened += p * b * 20
        taken += sum(c) * b * 20
    expect = (math.ceil(s / ROWS) * math.ceil(min(valid, s) / BLOCK) if kernel == "dkv"
              else math.ceil(valid / ROWS) * math.ceil(s / BLOCK)) * b * 20
    assert opened == expect and taken == CONSUMERS * expect
