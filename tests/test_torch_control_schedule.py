"""The schedule of P1's tensor-core route (csrc/attention_control.cu),
emulated in numpy on the CPU: no GPU needed.

The kernel gives each block 192 query rows (three consumers of 64) and, per
512-key tile, makes the scores of its four 128-key subtiles twice: pass A
keeps only their row max; pass B makes the same scores again, subtracts the
tile's new max, sums the unrounded p into l, rounds p to bf16 and adds
p @ v. The emulation follows that order, with the scores made once per pass
from the same operands (as the kernel's identical products are).

- At f32 (p not rounded) it equals ``attention_control_plain`` to 1e-5 of
  the largest value, and with p rounded to bf16 the plain bf16 version to
  1e-2, at S = 512 (rows past S in the last block), 1024 and 1536.
- A per-subtile online max (K2's 128-key schedule) is another function:
  it differs by more than 1e-2.
- The faults the card's mutation check puts into the kernel (m reset at a
  tile, the max over 128 keys, l from rounded p, p truncated, pass B on the
  wrong K subtile, consumer 2's rows one down) move the output or l beyond
  the card tests' bounds, and the kernel's own schedule stays inside them.
- Every mutant's text occurs once in its source, so each mutant is the one
  fault it names.
"""

import numpy as np
import pytest
import torch

from thewhisper_tpu_torch.ops import attention_control as ac
from thewhisper_tpu_torch.tools import mega_mutants

ROWS, CONSUMER_ROWS, TILE, SUB = 192, 64, 512, 128


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _trunc_bf16(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def schedule(q, k, v, round_p=True, fault=None):
    """The kernel's order for one (batch x head): q, k, v (S, 64) f32.
    Returns (out (S, 64) f32, rounded to bf16 when ``round_p``; l (S,)).
    ``fault`` names one of the card's mutants, or "online" for a max that
    moves with every 128-key subtile."""
    s_len = k.shape[0]
    out = np.zeros((s_len, q.shape[1]), np.float32)
    sums = np.zeros(s_len, np.float32)
    for q0 in range(0, s_len, ROWS):
        rows = np.zeros((ROWS, q.shape[1]), np.float32)
        n = min(ROWS, s_len - q0)
        rows[:n] = q[q0:q0 + n]                      # rows past S arrive as zeros
        m = np.full((ROWS, 1), -1e9, np.float32)
        l = np.zeros((ROWS, 1), np.float32)
        acc = np.zeros_like(rows)
        for t0 in range(0, s_len, TILE):
            def scores(j):
                """f32 scores of subtile j, summed in another order than
                the plain version's (as the tensor cores do)."""
                sub = k[t0 + SUB * j:t0 + SUB * (j + 1)]
                return (rows.astype(np.float64) @ sub.T.astype(np.float64)).astype(np.float32)

            tmax = np.full((ROWS, 1), -np.inf, np.float32)
            for j in range(TILE // SUB):             # pass A
                if fault == "max-128":
                    tmax[:] = -np.inf
                tmax = np.maximum(tmax, scores(j).max(-1, keepdims=True))
            m_new = np.maximum(np.float32(-1e9) if fault == "m-reset" else m, tmax)
            for j in range(TILE // SUB):             # pass B
                # The wrong K stage: the next subtile's (the next tile's first).
                s = scores(min(j + 1, (s_len - t0) // SUB - 1) if fault == "k-stage" else j)
                if fault == "online":
                    m_new = np.maximum(m, s.max(-1, keepdims=True))
                    m = m_new
                p = (s - m_new).astype(np.float32)
                rounded = p
                if round_p:
                    rounded = _trunc_bf16(p) if fault == "p-trunc" else _bf16(p)
                l = l + (rounded if fault == "l-round" else p).sum(
                    -1, keepdims=True, dtype=np.float32)
                vs = v[t0 + SUB * j:t0 + SUB * (j + 1)]
                acc = (acc + rounded.astype(np.float64) @ vs.astype(np.float64)).astype(np.float32)
            m = m_new
        res = acc / np.maximum(l, 1.0)
        if fault == "row-down":                      # consumer 2's rows, one down
            c2 = slice(2 * CONSUMER_ROWS, 3 * CONSUMER_ROWS)
            res[c2.start + 1:c2.stop] = res[c2.start:c2.stop - 1].copy()
        out[q0:q0 + n] = res[:n]
        sums[q0:q0 + n] = l[:n, 0]
    return (_bf16(out) if round_p else out), sums


def _inputs(seed, s_len, heads=2, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((heads, s_len, 64)).astype(np.float32) for _ in range(3))
    return _bf16(q * q_scale), _bf16(k), _bf16(v)


def _plain(q, k, v, dtype):
    """attention_control_plain over (1, heads, S, 64) and its l."""
    qt, kt, vt = (torch.from_numpy(t[None]).to(dtype) for t in (q, k, v))
    sums = torch.empty(qt.shape[:-1])
    out = ac.attention_control_plain(qt, kt, vt, row_sums=sums)
    return out[0].float().numpy(), sums[0].numpy()


def _run(q, k, v, **kw):
    outs, sums = zip(*(schedule(q[h], k[h], v[h], **kw) for h in range(q.shape[0])))
    return np.stack(outs), np.stack(sums)


@pytest.mark.parametrize("s_len", [512, 1024, 1536])
def test_schedule_equals_plain_f32(s_len):
    q, k, v = _inputs(s_len, s_len)
    out, sums = _run(q, k, v, round_p=False)
    ref, ref_sums = _plain(q, k, v, torch.float32)
    assert np.abs(ref).max() > 100                   # l <= 0: division by 1
    assert _rel(out, ref) < 1e-5
    assert _rel(sums, ref_sums) < 1e-5 and ref_sums.max() <= 0


@pytest.mark.parametrize("s_len,q_scale", [(512, 1.0), (1024, 1.0), (1536, 1.0),
                                           (1536, 4.0)])
def test_schedule_equals_plain_bf16(s_len, q_scale):
    """The bounds of the card tests: 1e-2 of the largest value, and 5e-4
    relative L2 (the same p rounded at the same point)."""
    q, k, v = _inputs(s_len + 1, s_len, q_scale=q_scale)
    out, _ = _run(q, k, v)
    ref, _ = _plain(q, k, v, torch.bfloat16)
    assert _rel(out, ref) < 1e-2
    assert _l2(out, ref) < 5e-4


@pytest.mark.parametrize("round_p", [False, True])
def test_online_subtile_max_is_another_function(round_p):
    q, k, v = _inputs(7, 1536)
    ref, _ = _plain(q, k, v, torch.bfloat16 if round_p else torch.float32)
    out, _ = _run(q, k, v, round_p=round_p, fault="online")
    assert _rel(out, ref) > 1e-2


@pytest.mark.parametrize("fault,caught_by", [
    ("m-reset", "max"), ("max-128", "max"), ("l-round", "l"), ("p-trunc", "l2"),
    ("k-stage", "max"), ("row-down", "max")])
def test_each_fault_leaves_the_card_bounds(fault, caught_by):
    """Each fault against the card tests' bounds: the output within 1e-2 of
    its largest value ("max") and 5e-4 relative L2 ("l2"), l within 1e-5 of
    its largest magnitude ("l"). The fault-free schedule on the same inputs
    stays within all three."""
    q, k, v = _inputs(11, 1536, q_scale=4.0)
    ref, ref_sums = _plain(q, k, v, torch.bfloat16)
    bounds = {"max": (_rel, 0, 1e-2), "l2": (_l2, 0, 5e-4), "l": (_rel, 1, 1e-5)}
    metric, which, bound = bounds[caught_by]
    clean = _run(q, k, v)
    assert metric(clean[which], (ref, ref_sums)[which]) < bound
    assert metric(_run(q, k, v, fault=fault)[which], (ref, ref_sums)[which]) > bound


@pytest.mark.parametrize("source,name,old", [(m[1], m[2], m[4]) for m in mega_mutants.MUTANTS],
                         ids=[m[2] for m in mega_mutants.MUTANTS])
def test_mutant_text_occurs_once_in_its_source(source, name, old):
    assert (mega_mutants.PACKAGE / source).read_text().count(old) == 1, name
