"""The f32 routes of K2 (with and without lse: K2-fwd-res and the inference
launch, csrc/encoder_attention.cu) and of K2-dkv and K2-dq
(csrc/encoder_attention_bwd.cu), emulated in torch on the CPU: no GPU
needed.

The kernels run every product on the tensor cores in 3xTF32: an f32
operand x is split into hi = rna(x) (``cvt.rna.tf32.f32``'s rounding: to 10
mantissa bits, ties away from zero) and lo = x - hi, which the tensor core
reads truncated to 10 mantissa bits, and a product is a_lo b_hi + a_hi b_lo
+ a_hi b_hi, summed in f32. The forward walks 64-key tiles
(online softmax in the log2 domain, keys >= valid_len at -inf on the last
tile, P in f32 split like any other operand); dK/dV holds 128 keys and walks
64-query tiles (P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T
(dP^T - di), queries past S taking lse = +inf and di = 0, keys >= valid_len
P = 0, dK scaled by 1 / sqrt(dh) at the end); dQ holds 128 queries and
walks the 64-key tiles below valid_len (P = exp2(S scale log2 e - lse
log2 e), keys >= valid_len of the last tile P = 0 by column, dS = P (dP -
di), dQ += dS K on the same K tile, scaled by 1 / sqrt(dh) at the end).
The tile sizes are read from the sources.

- The emulated forward, lse, dK/dV and dQ meet the card tests' bounds
  against the plain versions (output 1e-4 max abs, lse 1e-5 absolute,
  gradients 1e-4 relative L2) at S = 1, 77 (valid_len 30), 500 and 1500
  (valid_len 1100), and with scores in the hundreds (inputs times 8); the
  dQ walk also against the TPU library's own ``mha_reference_bwd``.
- The same walk in plain 1xTF32 breaks the output, lse and gradient
  bounds, so the lo terms are needed; dropping q's lo term from the score
  product alone, P^T's from dV's product alone or dS's from dQ's product
  alone (the mutation check's three 1xTF32 mutants), breaks them too.
- Leaving out either guard past S, with lse and di followed by NaN in
  memory (as the card test lays them out), puts NaN into dK.
- Each ring's producer and consumers, with the kernel's own mbarrier
  parities and arrival counts, meet in every interleaving tried: every
  consumer warp takes every tile after its bytes (and, for dK/dV, its lse
  and di columns) landed, and no stage is refilled while a warp reads it;
  a consumer parity off by one is caught.
"""

import functools
import math
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu_torch.ops import attention as ta

from _torch_tiny import one_cpu_thread  # noqa: F401

CSRC = Path(ta.__file__).resolve().parents[1] / "csrc"
FWD_SRC = (CSRC / "encoder_attention.cu").read_text()
BWD_SRC = (CSRC / "encoder_attention_bwd.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


FWD_WARPS, FWD_TILE, FWD_STAGES = (_const(FWD_SRC, n) for n in
                                   ("kF32Warps", "kF32Tile", "kF32Stages"))
BWD_WARPS, BWD_TILE, BWD_STAGES = (_const(BWD_SRC, n) for n in
                                   ("kF32Warps", "kF32Tile", "kF32Stages"))
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
SCALE_LOG2 = torch.tensor(0.125 * LOG2E, dtype=torch.float32)


def test_tiles_are_those_of_the_sources():
    assert "constexpr int kF32BlockQ = 16 * kF32Warps;" in FWD_SRC
    assert "constexpr int kF32Rows = 16 * kF32Warps;" in BWD_SRC
    assert FWD_TILE == BWD_TILE == 64 and FWD_STAGES >= 2 and BWD_STAGES >= 2


def rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32's rounding: the nearest value with 10 mantissa bits,
    ties away from zero (on the bit pattern: add half an ulp, clear the low
    13 bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register: its top 10 mantissa
    bits (the low 13 bits dropped)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


# The tensor cores' f32 accumulation. None: every product exact, the sums
# torch's f32 sums. An int n: mma.sync m16n8k8 as the card shows it, each
# k = 8 step adding the accumulator and its eight exact products after
# aligning them to the largest exponent among them and cutting each to n
# fraction bits toward zero, then rounding the sum toward zero to f32; the
# three products of a 3xTF32 step accumulate in turn (lo hi, hi lo, hi hi),
# as ``mma3`` in csrc/tf32_common.cuh orders them. n = 25 gives the card's
# f32 gradient errors (test_the_cards_accumulation_gives_its_gradient_errors).
ACCUMULATION = None


def _rz_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_k8(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """c + a b for a (.., M, 8), b (.., 8, N), c (.., M, N) f32, in the
    modelled accumulation (the aligned, cut addends sum exactly in f64)."""
    prods = a.double().unsqueeze(-1) * b.double().unsqueeze(-3)
    vals = torch.cat([c.double().unsqueeze(-2), prods], dim=-2)
    _, top = torch.frexp(vals.abs().amax(-2, keepdim=True))   # 2^(top-1) <= max < 2^top
    quantum = torch.ldexp(torch.ones(top.shape, dtype=torch.float64), top - 1 - bits)
    return _rz_f32((torch.trunc(vals / quantum) * quantum).sum(-2))


def mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3, a_lo: bool = True,
       acc: torch.Tensor = None) -> torch.Tensor:
    """acc + a @ b on the tensor cores (acc zero when None): 3xTF32
    (``terms`` 3), or plain TF32 (``terms`` 1); ``a_lo`` False leaves out
    a's lo term (a_lo b_hi); summed as ``ACCUMULATION`` says."""
    ah, bh = rna(a), rna(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    if ACCUMULATION is not None:
        c = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
        for k in range(0, a.shape[-1], 8):
            ks = slice(k, k + 8)
            pairs = ([(al, bh)] if terms == 3 and a_lo else []) + (
                [(ah, bl)] if terms == 3 else []) + [(ah, bh)]
            for x, y in pairs:
                c = _mma_k8(c, x[..., ks], y[..., ks, :], ACCUMULATION)
        return c
    out = ah @ bh if terms == 1 else (al @ bh if a_lo else 0) + ah @ bl + ah @ bh
    return out if acc is None else acc + out


def _pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, H, S, 64) zero-filled to ``rows`` rows: TMA's rows past S."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[2]))


def emulate_forward(q, k, v, valid, terms=3, q_lo=True):
    """(out (B, H, S, 64), lse (B, H, S)) of the forward's walk over 64-key
    tiles; q, k, v (B, H, S, 64) f32. Every query row is independent, so
    all rows walk at once."""
    n_tiles = math.ceil(valid / FWD_TILE)
    kp, vp = _pad(k, n_tiles * FWD_TILE), _pad(v, n_tiles * FWD_TILE)
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for t in range(n_tiles):
        keys = torch.arange(t * FWD_TILE, (t + 1) * FWD_TILE)
        sc = mm(q, kp[:, :, keys].transpose(-1, -2), terms, a_lo=q_lo)
        if (t + 1) * FWD_TILE > valid:
            sc = torch.where(keys < valid, sc, torch.tensor(-math.inf))
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2((m - m_new) * SCALE_LOG2)
        p = torch.exp2(sc * SCALE_LOG2 - (m_new * SCALE_LOG2)[..., None])
        l = l * corr + p.sum(-1)
        o = mm(p, vp[:, :, keys], terms, acc=o * corr[..., None])
        m = m_new
    return o / l[..., None], (m * SCALE_LOG2 + torch.log2(l)) * LN2


def _flat(x: torch.Tensor) -> torch.Tensor:
    """A (B, H, S) f32 row buffer followed by NaN: what lies past it."""
    return torch.cat([x.flatten(), torch.full((BWD_TILE,), float("nan"))])


def emulate_dkv(q, k, v, do, lse, di, valid, terms=3, p_lo=True, guard_lse=True,
                guard_di=True):
    """dK, dV of the dK/dV kernel's walk over 64-query tiles. q, k, v, do:
    (B, H, S, 64) f32; lse, di: (B, H, S) f32. Every key row is
    independent, so all keys walk at once; keys >= valid_len (their blocks
    write zeros, their rows in a live block get P = 0) end as zeros."""
    b, h, s, _ = q.shape
    n_tiles = math.ceil(s / BWD_TILE)
    qp, dop = _pad(q, n_tiles * BWD_TILE), _pad(do, n_tiles * BWD_TILE)
    lse_f, di_f = _flat(lse), _flat(di)
    bh0 = torch.arange(b * h).view(b, h) * s
    live = (torch.arange(s) < valid)[:, None]
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for t in range(n_tiles):
        cols = torch.arange(t * BWD_TILE, (t + 1) * BWD_TILE)
        qt, dot = qp[:, :, cols], dop[:, :, cols]
        lse2 = lse_f[bh0[..., None] + cols] * LOG2E
        di_c = di_f[bh0[..., None] + cols]
        if guard_lse:
            lse2 = torch.where(cols < s, lse2, torch.tensor(math.inf))
        if guard_di:
            di_c = torch.where(cols < s, di_c, torch.tensor(0.0))
        s_t = mm(k, qt.transpose(-1, -2), terms)            # S^T: keys x queries
        dp_t = mm(v, dot.transpose(-1, -2), terms)
        p = torch.where(live, torch.exp2(s_t * SCALE_LOG2 - lse2[:, :, None, :]),
                        torch.tensor(0.0))
        dv = mm(p, dot, terms, a_lo=p_lo, acc=dv)
        dk = mm(p * (dp_t - di_c[:, :, None, :]), qt, terms, acc=dk)
    return dk * 0.125, dv


def emulate_dq(q, k, v, do, lse, di, valid, terms=3, ds_lo=True):
    """dQ of the dQ kernel's walk over the 64-key tiles below ``valid``;
    q, k, v, do: (B, H, S, 64) f32; lse, di: (B, H, S) f32. Every query row
    is independent, so all queries walk at once; the keys >= valid of the
    last tile (real rows when valid < S, zero rows past S) get P = 0 by
    column. ``ds_lo`` False leaves dS's lo term out of dQ's product."""
    n_tiles = math.ceil(valid / BWD_TILE)
    kp, vp = _pad(k, n_tiles * BWD_TILE), _pad(v, n_tiles * BWD_TILE)
    lse2, di_r = (lse * LOG2E)[..., None], di[..., None]
    dq = torch.zeros(q.shape)
    for t in range(n_tiles):
        keys = torch.arange(t * BWD_TILE, (t + 1) * BWD_TILE)
        kt, vt = kp[:, :, keys], vp[:, :, keys]
        sc = mm(q, kt.transpose(-1, -2), terms)
        dp = mm(do, vt.transpose(-1, -2), terms)
        p = torch.where(keys < valid, torch.exp2(sc * SCALE_LOG2 - lse2), torch.tensor(0.0))
        dq = mm(p * (dp - di_r), kt, terms, a_lo=ds_lo, acc=dq)
    return dq * 0.125


def _case(b, h, s, valid_len, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (scale * torch.randn(b, s, h, 64, generator=g) for _ in range(4))
    out, lse = ta.encoder_attention_residuals(q, k, v, valid_len)
    return q, k, v, do, out, lse


def _bhsd(*xs):
    return [x.transpose(1, 2) for x in xs]


def _l2(got, ref):
    return ((got - ref).norm() / ref.norm()).item()


CASES = [(500, None), (77, 30), (1500, 1100)]


@functools.lru_cache(maxsize=None)
def _card_case(s, valid_len):
    """A case of CASES (B = 1 at S = 1500, else 2; H = 2; seed S), its di
    and the plain backward's gradients: the same for the undisturbed walks
    and for each disturbed one, so made once."""
    q, k, v, do, out, lse = _case(1 if s == 1500 else 2, 2, s, valid_len, seed=s)
    di = (out * do).sum(-1).transpose(1, 2)
    plain = ta.encoder_attention_backward_plain(q, k, v, out, lse, do, valid_len)
    return (q, k, v, do, out, lse), di, plain


def _errors(s, valid_len, walks=("fwd", "dkv", "dq"), terms=3, q_lo=True, p_lo=True,
            ds_lo=True) -> dict:
    """The named walks of ``_card_case(s, valid_len)`` against the plain
    versions on the same out and lse: the forward's output and lse max abs
    ("out", "lse"), dK/dV's relative L2 ("dk", "dv", and the walk's dK and
    dV under "dkv"), dQ's ("dq"). A disturbed walk is walked alone."""
    (q, k, v, do, out, lse), di, (pq, pk, pv) = _card_case(s, valid_len)
    valid = valid_len or s
    tq, tk, tv, tdo = _bhsd(q, k, v, do)
    errs = {}
    if "fwd" in walks:
        o, l = emulate_forward(tq, tk, tv, valid, terms, q_lo=q_lo)
        errs["out"] = (o.transpose(1, 2) - out).abs().max().item()
        errs["lse"] = (l - lse).abs().max().item()
    if "dkv" in walks:
        dk, dv = emulate_dkv(tq, tk, tv, tdo, lse, di, valid, terms, p_lo=p_lo)
        errs["dkv"] = dk, dv
        errs["dk"], errs["dv"] = _l2(dk.transpose(1, 2), pk), _l2(dv.transpose(1, 2), pv)
    if "dq" in walks:
        dq = emulate_dq(tq, tk, tv, tdo, lse, di, valid, terms, ds_lo=ds_lo)
        errs["dq"] = _l2(dq.transpose(1, 2), pq)
    return errs


@pytest.mark.parametrize("s,valid_len", CASES)
def test_walks_meet_the_card_bounds(s, valid_len):
    errs = _errors(s, valid_len)
    assert errs["out"] <= 1e-4 and errs["lse"] <= 1e-5, errs
    assert max(errs["dk"], errs["dv"], errs["dq"]) <= 1e-4, errs
    if valid_len is not None:
        dk, dv = errs["dkv"]
        assert not dk[:, :, valid_len:].any() and not dv[:, :, valid_len:].any()


def test_walks_meet_the_card_bounds_at_one_key():
    """S = 1: weight 1 on the one key, so out = v, lse is the scaled score,
    dV = dO, and dK and dQ vanish up to the rounding of dO v^T - di (the
    card test's absolute bound: no relative one holds a gradient that is
    zero but for rounding)."""
    q, k, v, do, out, lse = _case(2, 4, 1, None, seed=1)
    tq, tk, tv, tdo = _bhsd(q, k, v, do)
    o, l = emulate_forward(tq, tk, tv, 1)
    torch.testing.assert_close(o.transpose(1, 2), v, atol=1e-4, rtol=0)
    assert (l - lse).abs().max().item() <= 1e-5
    dk, dv = emulate_dkv(tq, tk, tv, tdo, lse, (out * do).sum(-1).transpose(1, 2), 1)
    torch.testing.assert_close(dv.transpose(1, 2), do, atol=0, rtol=1e-5)
    assert dk.abs().max().item() <= 1e-3
    dq = emulate_dq(tq, tk, tv, tdo, lse, (out * do).sum(-1).transpose(1, 2), 1)
    assert dq.abs().max().item() <= 1e-3


def test_forward_rescales_large_scores():
    """Inputs times 8: scores span hundreds, the running max moves from tile
    to tile. The card test's bound: 1e-4 of the output's largest value."""
    q, k, v, _, out, _ = _case(1, 2, 1500, None, seed=4, scale=8.0)
    o, _ = emulate_forward(*_bhsd(q, k, v), 1500)
    assert (o.transpose(1, 2) - out).abs().max().item() <= 1e-4 * out.abs().max().item()


@pytest.mark.parametrize("s,valid_len", CASES)
def test_plain_tf32_breaks_the_bounds(s, valid_len):
    """The same walks with every product in one TF32 product: the output,
    lse and both gradients leave their bounds."""
    errs = _errors(s, valid_len, terms=1)
    assert errs["out"] > 1e-4 and errs["lse"] > 1e-5, errs
    assert min(errs["dk"], errs["dv"], errs["dq"]) > 1e-4, errs


@pytest.mark.parametrize("s,valid_len", CASES)
def test_each_dropped_lo_term_breaks_a_bound(s, valid_len):
    """q's lo term left out of the score product: lse leaves 1e-5. P^T's
    left out of dV's product: dV leaves 1e-4. dS's left out of dQ's
    product: dQ leaves 1e-4."""
    assert _errors(s, valid_len, ("fwd",), q_lo=False)["lse"] > 1e-5
    assert _errors(s, valid_len, ("dkv",), p_lo=False)["dv"] > 1e-4
    assert _errors(s, valid_len, ("dq",), ds_lo=False)["dq"] > 1e-4


# The card's f32 gradient errors, dQ, dK and dV relative L2 against the
# plain backward (chip_smoke.py [TRAIN] at B = 8 x S = 500 and B = 4 x
# S = 1500, H = 20; NVIDIA H100 80GB HBM3, 700 W).
CARD_GRADIENT_ERRORS = {500: (4.76e-06, 4.75e-06, 4.39e-06),
                        1500: (1.17e-05, 1.17e-05, 1.14e-05)}


def _gradient_errors(s: int, accumulation, rows: int = None) -> tuple:
    """dQ, dK, dV relative L2 of the walks at B = 1, H = 2, S = s, with
    ``ACCUMULATION`` set as given for the call; with ``rows``, dQ alone
    on the first ``rows`` queries (each query row walks every key on its
    own, so a subset measures the same error at a fraction of the cost)."""
    global ACCUMULATION
    q, k, v, do, out, lse = _case(1, 2, s, None, seed=s)
    tq, tk, tv, tdo = _bhsd(q, k, v, do)
    di = (out * do).sum(-1).transpose(1, 2)
    pq, pk, pv = ta.encoder_attention_backward_plain(q, k, v, out, lse, do, None)
    part = slice(0, rows or s)
    was, ACCUMULATION = ACCUMULATION, accumulation
    try:
        dq = emulate_dq(tq[:, :, part], tk, tv, tdo[:, :, part], lse[:, :, part],
                        di[:, :, part], s)
        if rows:
            return (_l2(dq.transpose(1, 2), pq[:, part]),)
        dk, dv = emulate_dkv(tq, tk, tv, tdo, lse, di, s)
    finally:
        ACCUMULATION = was
    return tuple(_l2(g.transpose(1, 2), p) for g, p in ((dq, pq), (dk, pk), (dv, pv)))


def test_the_cards_accumulation_gives_its_gradient_errors():
    """With exact sums the dQ walk sits ten times below the card's dQ
    error; with the tensor cores' accumulation modelled (each k = 8 step's
    addends cut to 25 fraction bits after alignment, the sum rounded
    toward zero) it lands within 10% of it at S = 500, on 128 query rows.
    ``env PYTHONPATH=. JAX_PLATFORMS=cpu python
    tests/test_torch_attention_f32_schedule.py`` prints dQ, dK and dV on
    every row at S = 500 and 1500."""
    card = CARD_GRADIENT_ERRORS[500][0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # many small f64 passes: one thread a worker
    try:
        exact = _gradient_errors(500, None, rows=128)[0]
        got = _gradient_errors(500, 25, rows=128)[0]
    finally:
        torch.set_num_threads(threads)
    assert exact < card / 5, exact
    assert abs(got / card - 1) <= 0.1, (got, card)


def _library_dq(q, k, v, do, valid_len):
    """dQ of the TPU library's ``mha_reference_bwd`` on numpy (B, S, H, 64)
    inputs, as tests/test_torch_attention_grad.py calls it: it refuses
    ``sm_scale != 1``, so it gets q scaled by 1/sqrt(dh) and its dQ is
    scaled back; with valid_len it masks by segment ids, which agrees with
    the kernel's mask where dO is zero on the rows >= valid_len."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds,
        mha_reference_bwd,
        mha_reference_no_custom_vjp,
    )

    b, s = q.shape[:2]
    qt, kt, vt, dot = (jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))
                       for x in (q * 0.125, k, v, do))
    seg = None
    if valid_len is not None:
        ids = jnp.broadcast_to((jnp.arange(s) >= valid_len).astype(jnp.int32), (b, s))
        seg = SegmentIds(q=ids, kv=ids)
    with jax.default_matmul_precision("highest"):
        o, l, m = mha_reference_no_custom_vjp(qt, kt, vt, None, seg, save_residuals=True)
        dq = mha_reference_bwd(qt, kt, vt, None, seg, o, l, m, dot)[0]
    return torch.from_numpy(np.transpose(np.array(dq * 0.125), (0, 2, 1, 3)))


@pytest.mark.parametrize("s,valid_len", [(1, None)] + CASES)
def test_dq_walk_meets_the_library_reference(s, valid_len):
    """The dQ walk on numpy inputs (dO zero on the rows >= valid_len, as the
    encoder hands it back) against ``mha_reference_bwd``'s dQ and the plain
    backward's: 1e-4 relative L2; at S = 1, where dQ is zero but for
    rounding, 1e-3 absolute, the card test's bound."""
    rng = np.random.default_rng(s)
    q, k, v, do = (rng.standard_normal((1 if s == 1500 else 2, s, 2, 64)).astype(np.float32)
                   for _ in range(4))
    if valid_len is not None:
        do[:, valid_len:] = 0.0
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = ta.encoder_attention_residuals(tq, tk, tv, valid_len)
    di = (out * tdo).sum(-1).transpose(1, 2)
    dq = emulate_dq(*_bhsd(tq, tk, tv, tdo), lse, di, valid_len or s).transpose(1, 2)
    plain = ta.encoder_attention_backward_plain(tq, tk, tv, out, lse, tdo, valid_len)[0]
    for ref in (_library_dq(q, k, v, do, valid_len), plain):
        if s == 1:
            assert (dq - ref).abs().max().item() <= 1e-3
        else:
            assert _l2(dq, ref) <= 1e-4


@pytest.mark.parametrize("left_out", ["lse", "di"])
def test_leaving_out_a_guard_past_s_puts_nan_into_dk(left_out):
    """S = 77: the last (batch, head) row's second query tile reads 51
    columns past S, where memory holds NaN. With both guards dK is finite;
    without the lse guard P is NaN there, without the di guard dS is."""
    q, k, v, do, out, lse = _case(2, 2, 77, None, seed=3)
    tq, tk, tv, tdo = _bhsd(q, k, v, do)
    di = (out * do).sum(-1).transpose(1, 2)
    dk, _ = emulate_dkv(tq, tk, tv, tdo, lse, di, 77)
    assert torch.isfinite(dk).all()
    broken, _ = emulate_dkv(tq, tk, tv, tdo, lse, di, 77, guard_lse=left_out != "lse",
                            guard_di=left_out != "di")
    assert not torch.isfinite(broken[-1, -1]).all()


def _kernel(src: str, name: str) -> str:
    """The text of one kernel's body in a source."""
    start = src.index(f"{name}(")
    return src[start:src.index("\n}\n", start)]


def _instance(body: str, keys: bool) -> str:
    """The text of one instance of the backward's kernel template: each
    ``if (kKeys) { ... }`` block kept (dK/dV) or dropped (dQ), each
    ``kKeys ? a : b`` of two words resolved."""
    while (i := body.find("if (kKeys) {")) >= 0:
        j = body.index("{", i)
        depth = 0
        for end in range(j, len(body)):
            depth += {"{": 1, "}": -1}.get(body[end], 0)
            if depth == 0:
                break
        body = body[:i] + (body[j + 1:end] if keys else "") + body[end + 1:]
    return re.sub(r"kKeys \? (\w+) : (\w+)", r"\1" if keys else r"\2", body)


BWD_KERNEL = _kernel(BWD_SRC, "attention_bwd_f32_kernel")

# The rings: each f32 kernel's body, its stages, MMA warps and full
# barrier's arrival count (dK/dV: the TMA's, then the 32 lanes' columns).
RINGS = {
    "forward": (_kernel(FWD_SRC, "encoder_attention_f32_kernel"), FWD_STAGES, FWD_WARPS, 1),
    "dkv": (_instance(BWD_KERNEL, True), BWD_STAGES, BWD_WARPS, 33),
    "dq": (_instance(BWD_KERNEL, False), BWD_STAGES, BWD_WARPS, 1),
}


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_the_kernels_wait_on_the_parities_walked_here(ring):
    body, _, _, full_count = RINGS[ring]
    assert "if (t >= kF32Stages) mbar_wait(&empty[st], ((t / kF32Stages) - 1) & 1);" in body
    assert "mbar_wait(&full[st], (t / kF32Stages) & 1);" in body
    assert "mbar_init(&empty[s], 32 * kF32Warps);" in body
    assert f"mbar_init(&full[s], {full_count});" in body
    assert ("mbar_arrive(&full[st]);" in body) == (full_count == 33)


class Barrier:
    """An mbarrier: a phase completes once ``count`` arrivals and every
    expected transaction byte have come; try_wait.parity(p) passes once the
    phase of parity p has completed, that is while the current phase's
    parity differs from p."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phases = count, count, 0, 0

    def passes(self, parity):
        return (self.phases & 1) != parity

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.phases, self.pending = self.phases + 1, self.count

    def arrive(self, n=1, tx=0):
        self.pending -= n
        self.tx += tx
        self._check()

    def land(self, tx):
        self.tx -= tx
        self._check()


def walk_ring(n_tiles, stages, warps, cols, rng, parity_shift=0):
    """One block's producer warp (its TMA issue, the bytes landing later,
    and for dK/dV its 32 lanes' columns) and MMA warps under a random
    interleaving, with the kernel's parities (the consumers' shifted by
    ``parity_shift``). Returns the tiles each warp took."""
    full = [Barrier(33 if cols else 1) for _ in range(stages)]
    empty = [Barrier(32 * warps) for _ in range(stages)]
    tile = [None] * stages        # the tile a stage was opened for
    landed = [False] * stages     # its bytes (and columns) are in
    readers = [set() for _ in range(stages)]
    inflight = []                 # stages whose TMA bytes have not landed
    state = {"opened": 0, "step": 0}   # producer: 0 open (TMA), 1 columns
    taken = [0] * warps
    reading = [False] * warps

    def producer():
        t = state["opened"]
        st = t % stages
        if state["step"] == 0:
            if t >= stages and not empty[st].passes(((t // stages) - 1) & 1):
                return False
            assert not readers[st], "a stage refilled while a warp reads it"
            tile[st], landed[st] = t, False
            full[st].arrive(1, tx=1)          # expect_tx, then the loads
            inflight.append(st)
            state["step"] = 1 if cols else 0
            if not cols:
                state["opened"] += 1
            return True
        full[st].arrive(32)                   # the lanes' lse and di columns
        state["step"], state["opened"] = 0, t + 1
        return True

    def land():
        st = inflight.pop(rng.randrange(len(inflight)))
        landed[st] = True
        full[st].land(1)
        return True

    def consumer(w):
        t = taken[w]
        st = t % stages
        if not reading[w]:
            if not full[st].passes(((t // stages) + parity_shift) & 1):
                return False
            assert tile[st] == t and landed[st], f"warp {w} read tile {tile[st]} as {t}"
            assert not cols or state["opened"] > t, "columns not written"
            readers[st].add(w)
            reading[w] = True
        else:
            readers[st].discard(w)
            empty[st].arrive(32)
            reading[w], taken[w] = False, t + 1
        return True

    while state["opened"] < n_tiles or min(taken) < n_tiles:
        movers = [(lambda w=w: consumer(w)) for w in range(warps) if taken[w] < n_tiles]
        if state["opened"] < n_tiles:
            movers.append(producer)
        if inflight:
            movers.append(land)
        rng.shuffle(movers)
        assert any(m() for m in movers), "deadlock"
    return taken


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("s,valid_len", [(500, None), (1500, None), (1500, 1100), (77, 30)])
def test_producer_and_consumers_walk_the_same_stages(ring, s, valid_len):
    _, stages, warps, full_count = RINGS[ring]
    valid = valid_len or s
    n_tiles = math.ceil((s if ring == "dkv" else valid) / 64)
    rng = random.Random(s + stages)
    for _ in range(20):
        assert walk_ring(n_tiles, stages, warps, full_count != 1, rng) == [n_tiles] * warps


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_a_parity_off_by_one_is_caught(ring):
    _, stages, warps, full_count = RINGS[ring]
    with pytest.raises(AssertionError):
        walk_ring(8, stages, warps, full_count != 1, random.Random(0), parity_shift=1)


if __name__ == "__main__":
    # The accumulation models against the card's gradient errors (a few
    # minutes on a CPU at S = 1500).
    for s_len, card in CARD_GRADIENT_ERRORS.items():
        for bits in (None, 24, 25, 26):
            errs = _gradient_errors(s_len, bits)
            print(f"S = {s_len}, accumulation {bits}: dQ, dK, dV relative L2 "
                  f"{', '.join(f'{e:.2e}' for e in errs)}; card "
                  f"{', '.join(f'{e:.2e}' for e in card)}", flush=True)
