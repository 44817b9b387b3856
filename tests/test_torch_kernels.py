"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips elsewhere:
a CUDA kernel has no CPU mode. The module imports no JAX, so it also runs
where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Shapes are the slice's production shapes: 10 s and 30 s of audio (1000 and
3000 frames), S = 1500 and 500 encoder positions, 20 heads of 64; K3 (the
decode step) and K4 (the verify window) at a small arch, d_model 384 with
heads of 64 and 2 layers, with T and cache lengths that are and are not
multiples of their attention chunks (chip_smoke.py holds them at large-v3
width; ``python -m thewhisper_tpu_torch.tools.mega_mutants`` checks that
these tests fail on broken copies of their engine), and the decode loops
that run them captured into CUDA graphs: greedy steps, sampled steps
(the generator registered with the graph) and speculative rounds (K4 at
a device window position), each replayed equal to the eager loop. The
probe kernels (P1-P5) at small sizes: the no-exp attention control at
S = 512 (one block's query rows past S), 1024 and 1536 and at the probe's 20
heads (``mega_mutants`` checks these tests too against broken copies of
P1's kernel), the int8 MLP chain at d_model 256, d_ff 1024 and at the
probe's 1280 and 5120 (``mega_mutants --kernel mlp`` checks these against
broken copies of P2/P3's kernel), the slot writes at the probes' own cache
shapes and at every Whisper width, with host and device slots, replayed
from CUDA graphs at slots refilled on the card, in a P5 -> P4 -> P4 relay
that checks the programmatic launches' ordering, and a device slot outside
the cache trapping in a child process (``mega_mutants --kernel cache``
checks these against broken copies of ``csrc/cache_write.cu``). K2's lse
and its backward kernels at S = 1, the bf16 route's tile edges 64, 65 and
128, a ragged 77 (with valid_len 30), 500 and 1500 (valid_len 1100), with
other query than key counts (13 over 52, 750, 375 and 188 over 1500, 200
over 77), f32 and bf16, with lse and di that hold NaN past their last row, and through
autograd on the encoder's strided views (``mega_mutants --kernel
attn_bwd`` checks these and K2's own tests against broken copies of
``csrc/encoder_attention_bwd.cu``, of ``csrc/tc_common.cuh`` and of K2's
f32 route and lse stores). Q4, the "S4" int4 linear, at M = 1, 3, 32, 33,
160, 1500 and 6000 rows and either side of its routes' crossover, at
large-v3's linear shapes, bf16 and f32, exact on identity rows on every
route, deterministic, replayed from a CUDA graph bit for bit, refusing what
it does not take (``mega_mutants --kernel int4`` checks these against
broken copies of ``csrc/int4_linear.cu``).
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from thewhisper_tpu_torch.audio import features as tf
from thewhisper_tpu_torch.config import WhisperArch
from thewhisper_tpu_torch.models import quant as tq
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.ops import _build, logmel
from thewhisper_tpu_torch.ops import attention as ta
from thewhisper_tpu_torch.ops import attention_control as tac
from thewhisper_tpu_torch.ops import cache_write as tcw
from thewhisper_tpu_torch.ops import int4_linear as tq4
from thewhisper_tpu_torch.ops import mega_step as tm
from thewhisper_tpu_torch.ops import mlp_chain as tmc
from thewhisper_tpu_torch.tools._card import capture

from _torch_tiny import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _sig(batch, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    rows = [0.4 * np.sin(2 * np.pi * (180 + 80 * t + 40 * b) * t)
            + 0.05 * rng.standard_normal(len(t)) for b in range(batch)]
    return np.stack(rows).astype(np.float32)


def test_build_reports_resources(cuda_device):
    """The library builds (or loads) and exports every entry point."""
    lib = _build.lib()
    for name in ("twt_logmel", "twt_encoder_attention", "twt_attention_bwd_dkv",
                 "twt_attention_bwd_dq", "twt_mega_step",
                 "twt_mega_verify", "twt_attention_control", "twt_mlp_chain",
                 "twt_write_row", "twt_write_column", "twt_empty_launch",
                 "twt_int4_linear"):
        assert hasattr(lib, name)
    if _build.build_log is not None:
        print(_build.build_log)


@pytest.mark.parametrize("batch,seconds,n_mels", [
    (1, 30.0, 128), (4, 10.0, 80), (4, 30.0, 128), (2, 1.3, 128),
    (1, 30.0, 80)])
def test_logmel_kernel_matches_plain(cuda_device, batch, seconds, n_mels):
    audio = torch.from_numpy(_sig(batch, seconds)).to(cuda_device)
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=n_mels)).to(cuda_device)
    win = torch.from_numpy(tf.hann_window()).to(cuda_device)
    before = logmel.LOGMEL_LAUNCHES
    out = tf.log_mel_spectrogram(audio, fb, win)
    torch.cuda.synchronize()
    assert logmel.LOGMEL_LAUNCHES == before + 1
    ref = tf.log_mel_spectrogram_plain(audio, fb, win)
    # The bound tests/test_logmel_pallas.py holds the TPU kernel to.
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=0)


def test_logmel_kernel_takes_unaligned_audio(cuda_device):
    """The kernel stages the audio as float4s; a view whose data starts off
    a 16-byte boundary gives the same features."""
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=80)).to(cuda_device)
    win = torch.from_numpy(tf.hann_window()).to(cuda_device)
    padded = torch.from_numpy(_sig(1, 3.0 + 1 / 16000)).to(cuda_device)
    audio = padded[:, 1:]                                 # 4 bytes past the base
    assert audio.data_ptr() % 16 and audio.shape == (1, 48000)
    torch.testing.assert_close(tf.log_mel_spectrogram(audio, fb, win),
                               tf.log_mel_spectrogram_plain(audio, fb, win),
                               atol=5e-4, rtol=0)


def test_logmel_kernel_rejects_bad_input(cuda_device):
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=80)).to(cuda_device)
    win = torch.from_numpy(tf.hann_window()).to(cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        logmel.log_mel(torch.zeros(1, 1000, device=cuda_device), fb, win)
    with pytest.raises(ValueError, match="float32"):
        logmel.log_mel(torch.zeros(1, 1600, device=cuda_device,
                                   dtype=torch.float64), fb, win)


def test_trace_records_a_logmel_launch(cuda_device, tmp_path):
    """``utils.profiling.trace`` on the card: its file holds K1's launch as
    a device kernel event inside the ``annotate`` span's time, one a call."""
    from thewhisper_tpu_torch.utils import profiling

    audio = torch.from_numpy(_sig(1, 30.0)).to(cuda_device)
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=128)).to(cuda_device)
    win = torch.from_numpy(tf.hann_window()).to(cuda_device)
    tf.log_mel_spectrogram(audio, fb, win)                # builds and warms
    torch.cuda.synchronize()
    before = logmel.LOGMEL_LAUNCHES
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("k1-call"):
            tf.log_mel_spectrogram(audio, fb, win)
            torch.cuda.synchronize()
    assert logmel.LOGMEL_LAUNCHES == before + 1
    events = profiling.trace_events(str(tmp_path))
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "logmel_kernel" in e["name"]]
    (span,) = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "k1-call"]
    assert len(kernels) == 1 and kernels[0]["dur"] > 0
    assert span["ts"] <= kernels[0]["ts"] <= span["ts"] + span["dur"]
    busy, _ = profiling.device_idle(events, span["ts"], span["ts"] + span["dur"])
    assert busy >= kernels[0]["dur"]


def _qkv(b, s, h, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, s, h, 64, generator=g).to(device, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,valid_len", [
    (4, 1500, None), (4, 500, None), (2, 1500, 1111), (1, 77, 5),
    (1, 1500, None), (1, 1536, None)])
def test_attention_kernel_matches_plain(cuda_device, dtype, b, s, valid_len):
    q, k, v = _qkv(b, s, 20, dtype, cuda_device)
    before = ta.ATTN_LAUNCHES
    out = ta.encoder_attention(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    assert ta.ATTN_LAUNCHES == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = ta.encoder_attention_plain(q, k, v, valid_len=valid_len)
    # f32: summation order only. bf16: both round the probabilities to bf16
    # before the value product, but the kernel rounds them unnormalized
    # (relative to a running max) and divides after; the output rounds to
    # bf16 once.
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_attention_kernel_bf16_rescales_large_scores(cuda_device):
    """Inputs scaled by 8: scores span hundreds, so the running max moves
    from tile to tile and every earlier tile's sum must be rescaled. Bound:
    2e-2 of the output's largest value."""
    q, k, v = (8 * x for x in _qkv(2, 1500, 20, torch.bfloat16, cuda_device, seed=4))
    out = ta.encoder_attention(q, k, v)
    ref = ta.encoder_attention_plain(q, k, v)
    assert _rel(out, ref) < 2e-2


def test_attention_kernel_f32_rescales_large_scores(cuda_device):
    """The f32 route (3xTF32) on inputs scaled by 8: scores span hundreds,
    so the running max moves from tile to tile and every earlier tile's sum
    must be rescaled. Bound: the f32 route's 1e-4, of the output's largest
    value (the output is 8x larger here)."""
    q, k, v = (8 * x for x in _qkv(2, 1500, 20, torch.float32, cuda_device, seed=4))
    out = ta.encoder_attention(q, k, v)
    ref = ta.encoder_attention_plain(q, k, v)
    assert _rel(out, ref) < 1e-4


def test_attention_kernel_bf16_one_valid_key_is_exact(cuda_device):
    """valid_len = 1: every query attends key 0 alone with weight exactly 1,
    so the output is v[:, 0] bit for bit."""
    q, k, v = _qkv(2, 300, 20, torch.bfloat16, cuda_device, seed=5)
    out = ta.encoder_attention(q, k, v, valid_len=1)
    torch.cuda.synchronize()
    assert torch.equal(out, v[:, :1].expand_as(out))


def test_attention_kernel_bf16_rejects_misaligned_operands(cuda_device):
    """TMA needs 16-byte-aligned base pointers and strides."""
    flat = torch.zeros(100 * 20 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 100, 20, 64)                     # base + 2 bytes
    ok = torch.zeros(1, 100, 20, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ta.encoder_attention(shifted, ok, ok)
    wide = torch.zeros(1, 100, 20, 68, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):                 # 136-byte head stride
        ta.encoder_attention(ok, wide[..., :64], ok)


def test_attention_kernel_takes_strided_views(cuda_device):
    """The encoder passes (B, S, H, dh) views of (B, S, d) projections."""
    x = torch.randn(2, 300, 3 * 20 * 64, device=cuda_device)
    q, k, v = (t.view(2, 300, 20, 64) for t in x.chunk(3, dim=-1))
    torch.testing.assert_close(ta.encoder_attention(q, k, v),
                               ta.encoder_attention_plain(q, k, v),
                               atol=1e-4, rtol=1e-4)


def test_attention_kernel_bf16_takes_strided_views(cuda_device):
    """The bf16 route's tensor maps over the encoder's views of (B, S, d)
    projections and over (B, H, S, dh) tensors transposed (the probes')."""
    x = torch.randn(2, 300, 3 * 20 * 64, device=cuda_device).to(torch.bfloat16)
    q, k, v = (t.view(2, 300, 20, 64) for t in x.chunk(3, dim=-1))
    ref = ta.encoder_attention_plain(q, k, v)
    assert _rel(ta.encoder_attention(q, k, v), ref) < 2e-2
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert _rel(ta.encoder_attention(qt, kt, vt), ref) < 2e-2


def test_attention_kernel_rejects_bad_input(cuda_device):
    x = torch.zeros(1, 16, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ta.encoder_attention(x, x, x)
    y = torch.zeros(1, 16, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ta.encoder_attention(y, y, y)
    z = torch.zeros(1, 16, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="valid_len"):
        ta.encoder_attention(z, z, z, valid_len=0)


def _l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,valid_len", [
    (1, 64, None), (2, 65, None), (1, 128, None), (2, 130, 65),
    (1, 77, None), (2, 77, 30), (2, 500, None), (1, 1500, 1100)])
def test_attention_backward_kernels_match_plain(cuda_device, dtype, b, s, valid_len):
    """K2 with lse, then K2-dkv and K2-dq, against the plain versions on the
    same out and lse. f32: lse to 1e-5 absolute, gradients to 1e-4
    relative L2 (the same f32 sums in another order). bf16: each
    gradient's distance from the f32 gradients of the same inputs at most
    1.5x the plain bf16 version's (both round P and dS to bf16); dK and dV
    of keys >= valid_len exactly zero."""
    q, k, v = _qkv(b, s, 4, dtype, cuda_device, seed=7)
    do = _qkv(b, s, 4, dtype, cuda_device, seed=8)[0]
    counts = (ta.ATTN_RES_LAUNCHES, ta.ATTN_BWD_DKV_LAUNCHES, ta.ATTN_BWD_DQ_LAUNCHES)
    out, lse = ta.encoder_attention_residuals(q, k, v, valid_len)
    got = ta.encoder_attention_backward(q, k, v, out, lse, do, valid_len)
    torch.cuda.synchronize()
    assert (ta.ATTN_RES_LAUNCHES, ta.ATTN_BWD_DKV_LAUNCHES,
            ta.ATTN_BWD_DQ_LAUNCHES) == tuple(c + 1 for c in counts)
    assert lse.shape == (b, 4, s) and lse.dtype == torch.float32
    ref_lse = ta.attention_lse_plain(q, k, valid_len)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5 if dtype == torch.float32
                               else 1e-4, rtol=0)
    torch.testing.assert_close(out, ta.encoder_attention(q, k, v, valid_len),
                               rtol=0, atol=0)
    plain = ta.encoder_attention_backward_plain(q, k, v, out, lse, do, valid_len)
    for g in got:
        assert g.shape == q.shape and g.dtype == dtype and g.is_contiguous()
    if valid_len is not None:
        assert not got[1][:, valid_len:].any() and not got[2][:, valid_len:].any()
    if dtype == torch.float32:
        for name, g, r in zip("qkv", got, plain):
            assert _l2(g, r) <= 1e-4, name
        return
    f = [x.float() for x in (q, k, v, do)]
    out32, lse32 = ta.encoder_attention_residuals(*f[:3], valid_len)
    ref = ta.encoder_attention_backward_plain(*f[:3], out32, lse32, f[3], valid_len)
    for name, g, p, r in zip("qkv", got, plain, ref):
        assert _l2(g, r) <= 1.5 * _l2(p, r), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k,valid_len", [
    (13, 52, 50), (750, 1500, None), (375, 1500, None), (188, 1500, None),
    (200, 77, 30)])
def test_attention_backward_kernels_take_other_query_and_key_counts(
        cuda_device, dtype, s_q, s_k, valid_len):
    """S_q != S_k (the sequence-parallel encoder's backward: a rank's
    queries over the keys gathered from every rank, tp 4 of T = 50 and tp
    2, 4 and 8 of T = 1500): dQ in q's shape, dK and dV in k's, against the
    plain version by the rules of the square test; pad keys' dK and dV
    exactly zero."""
    q = _qkv(2, s_q, 4, dtype, cuda_device, seed=13)[0]
    do = _qkv(2, s_q, 4, dtype, cuda_device, seed=14)[0]
    k, v = _qkv(2, s_k, 4, dtype, cuda_device, seed=15)[1:]
    out, lse = ta.encoder_attention_residuals(q, k, v, valid_len)
    got = ta.encoder_attention_backward(q, k, v, out, lse, do, valid_len)
    torch.cuda.synchronize()
    plain = ta.encoder_attention_backward_plain(q, k, v, out, lse, do, valid_len)
    for g, p in zip(got, plain):
        assert g.shape == p.shape and g.dtype == dtype and g.is_contiguous()
    if valid_len is not None:
        assert not got[1][:, valid_len:].any() and not got[2][:, valid_len:].any()
    if dtype == torch.float32:
        for name, g, r in zip("qkv", got, plain):
            assert _l2(g, r) <= 1e-4, name
        return
    f = [x.float() for x in (q, k, v, do)]
    out32, lse32 = ta.encoder_attention_residuals(*f[:3], valid_len)
    ref = ta.encoder_attention_backward_plain(*f[:3], out32, lse32, f[3], valid_len)
    for name, g, p, r in zip("qkv", got, plain, ref):
        assert _l2(g, r) <= 1.5 * _l2(p, r), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernels_one_key(cuda_device, dtype):
    """S = 1: each query attends its one key with weight 1, so lse is the
    scaled score, dV = dO, and dQ and dK vanish up to the rounding of
    dO v^T - di (which a relative bound cannot hold)."""
    q, k, v = _qkv(2, 1, 4, dtype, cuda_device, seed=9)
    do = _qkv(2, 1, 4, dtype, cuda_device, seed=10)[0]
    out, lse = ta.encoder_attention_residuals(q, k, v)
    dq, dk, dv = ta.encoder_attention_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    scores = (q.float() * k.float()).sum(-1).transpose(1, 2) * 0.125
    torch.testing.assert_close(lse, scores, atol=1e-4, rtol=0)
    torch.testing.assert_close(dv.float(), do.float(), atol=0,
                               rtol=1e-5 if dtype == torch.float32 else 1e-2)
    assert dq.float().abs().max() <= 1e-3 and dk.float().abs().max() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_attention_autograd_on_the_card(cuda_device, dtype):
    """Under grad, ``encoder_attention`` on the encoder's strided views (the
    chunks of one (B, S, 3 H 64) leaf, which the bf16 route's tensor maps
    meet as they are) launches K2 with lse once and each backward kernel
    once. f32: its gradient equals autograd of the plain version to 1e-4
    relative L2. bf16: its distance from the f32 plain gradient is at most
    1.5x the plain bf16 autograd's."""
    x = torch.randn(2, 300, 3 * 20 * 64, device=cuda_device)
    grads = []
    counts = (ta.ATTN_LAUNCHES, ta.ATTN_RES_LAUNCHES, ta.ATTN_BWD_DKV_LAUNCHES,
              ta.ATTN_BWD_DQ_LAUNCHES)
    runs = [(ta.encoder_attention, dtype), (ta.encoder_attention_plain, dtype)]
    if dtype == torch.bfloat16:
        runs.append((ta.encoder_attention_plain, torch.float32))
    for fn, run_dtype in runs:
        # A leaf of its own each run (``to`` returns x itself when the type
        # matches, and the runs would then sum into one .grad).
        leaf = x.to(dtype).to(run_dtype).clone().requires_grad_(True)
        q, k, v = (t.view(2, 300, 20, 64) for t in leaf.chunk(3, dim=-1))
        fn(q, k, v).float().square().sum().backward()
        grads.append(leaf.grad)
    torch.cuda.synchronize()
    assert (ta.ATTN_LAUNCHES, ta.ATTN_RES_LAUNCHES, ta.ATTN_BWD_DKV_LAUNCHES,
            ta.ATTN_BWD_DQ_LAUNCHES) == (counts[0], *(c + 1 for c in counts[1:]))
    if dtype == torch.float32:
        assert _l2(*grads) <= 1e-4
    else:
        assert _l2(grads[0], grads[2]) <= 1.5 * _l2(grads[1], grads[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_reads_nothing_past_s(cuda_device, dtype):
    """lse and di as the first rows of buffers that hold NaN after them:
    the last (batch, head) row's query tile runs past S (77 is no tile
    multiple), and the kernels must neither read lse or di there nor let
    those queries into the sums, so the gradients equal those from
    ordinary lse and di bit for bit."""
    q, k, v = _qkv(2, 77, 4, dtype, cuda_device, seed=11)
    do = _qkv(2, 77, 4, dtype, cuda_device, seed=12)[0]
    out, lse = ta.encoder_attention_residuals(q, k, v)
    di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    guarded = []
    for x in (lse, di):
        buf = torch.full((x.numel() + 256,), float("nan"), device=cuda_device)
        buf[:x.numel()] = x.flatten()
        guarded.append(buf[:x.numel()].view(x.shape))
    for launch in (ta.launch_backward_dkv, ta.launch_backward_dq):
        ref = launch(q, k, v, do, lse, di, 77)
        got = launch(q, k, v, do, *guarded, 77)
        torch.cuda.synchronize()
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.isfinite(g).all() and torch.equal(g, r)


def test_attention_backward_bf16_rejects_misaligned_operands(cuda_device):
    """The bf16 route's TMA needs 16-byte-aligned base pointers and strides
    of q, k, v and dout."""
    flat = torch.zeros(100 * 20 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 100, 20, 64)                     # base + 2 bytes
    ok = torch.zeros(1, 100, 20, 64, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, 20, 100, device=cuda_device)
    for args in ((shifted, ok, ok, ok), (ok, ok, shifted, ok), (ok, ok, ok, shifted)):
        q, k, v, do = args
        with pytest.raises(ValueError, match="TMA"):
            ta.encoder_attention_backward(q, k, v, ok, lse, do)
    wide = torch.zeros(1, 100, 20, 68, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):                     # 136-byte head stride
        ta.encoder_attention_backward(ok, wide[..., :64], ok, ok, lse, ok)


def test_attention_kernels_f32_reject_misaligned_operands(cuda_device):
    """The f32 routes of K2 and K2-dkv load by TMA too: a base pointer 4
    bytes off, or a 264-byte head stride, raises instead of launching."""
    flat = torch.zeros(100 * 20 * 64 + 1, device=cuda_device)
    shifted = flat[1:].view(1, 100, 20, 64)                     # base + 4 bytes
    ok = torch.zeros(1, 100, 20, 64, device=cuda_device)
    wide = torch.zeros(1, 100, 20, 66, device=cuda_device)[..., :64]
    lse = torch.zeros(1, 20, 100, device=cuda_device)
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            ta.encoder_attention(ok, bad, ok)
        for q, k, v, do in ((bad, ok, ok, ok), (ok, ok, bad, ok), (ok, ok, ok, bad)):
            with pytest.raises(ValueError, match="TMA"):
                ta.encoder_attention_backward(q, k, v, ok, lse, do)


def test_attention_backward_dq_f32_rejects_misaligned_operands(cuda_device):
    """The f32 dQ kernel loads q, k, v and dout by TMA: its entry point,
    called without the wrapper's check, refuses an operand whose base
    pointer is 4 bytes off (cudaErrorInvalidValue, 1) and launches nothing."""
    flat = torch.zeros(100 * 20 * 64 + 1, device=cuda_device)
    shifted = flat[1:].view(1, 100, 20, 64)                     # base + 4 bytes
    ok = torch.zeros(1, 100, 20, 64, device=cuda_device)
    lse = torch.zeros(1, 20, 100, device=cuda_device)
    for q, k, v, do in ((shifted, ok, ok, ok), (ok, shifted, ok, ok),
                        (ok, ok, shifted, ok), (ok, ok, ok, shifted)):
        count = ta.ATTN_BWD_DQ_LAUNCHES
        with pytest.raises(RuntimeError, match="twt_attention_bwd_dq: CUDA error 1 "):
            ta.launch_backward_dq(q, k, v, do, lse, lse, 100)
        assert ta.ATTN_BWD_DQ_LAUNCHES == count
    torch.cuda.synchronize()


def test_attention_backward_rejects_bad_input(cuda_device):
    q = torch.zeros(1, 16, 2, 64, device=cuda_device)
    lse = torch.zeros(1, 2, 16, device=cuda_device)
    wide = torch.zeros(1, 16, 2, 128, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="head dim must be contiguous"):
        ta.encoder_attention_backward(wide, q, q, q, lse, q)
    with pytest.raises(ValueError, match="head dim must be contiguous"):
        ta.encoder_attention_backward(q, q, q, q, lse, wide)
    small = torch.zeros(1, 16, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 32"):
        ta.encoder_attention_backward(small, small, small, small, lse, small)
    with pytest.raises(ValueError, match="lse"):
        ta.encoder_attention_backward(q, q, q, q, lse[:, :, :8], q)
    with pytest.raises(ValueError, match="valid_len"):
        ta.encoder_attention_backward(q, q, q, q, lse, q, valid_len=17)


K3_ARCH = WhisperArch(
    d_model=384, encoder_layers=1, encoder_heads=6, decoder_layers=2,
    decoder_heads=6, d_ff=1536, n_mels=80, vocab_size=500,
    max_source_positions=96, max_target_positions=64,
    alignment_heads=((0, 1), (1, 3)))


def _k3_case(device, slots, t_enc=96, seed=0, d_ff=K3_ARCH.d_ff):
    """A packed bf16 "S" model (random biases and LayerNorm parameters) and
    a batch-1 cache with random K/V."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    model = tw.init_params(dataclasses.replace(K3_ARCH, d_ff=d_ff), g,
                           dtype=torch.bfloat16, bias_std=0.1).to(device)
    tq.quantize_params(model)
    tm.pack_mega_params(tw.fuse_self_qkv(model))
    shape = (2, 1, 6, t_enc, 64)
    ck, cv = (tq.quantize_kv(torch.randn(shape, generator=g).to(device))
              for _ in range(2))
    cache = tw.make_cache(K3_ARCH, 1, slots, ck, cv, dtype=torch.bfloat16)
    for t in (cache.self_k, cache.self_v):
        t.copy_(0.5 * torch.randn(t.shape, generator=g))
    return model, cache


@pytest.mark.parametrize("slots,pos", [(5, 4), (16, 9), (60, 0), (60, 59)])
def test_mega_step_kernel_matches_plain(cuda_device, slots, pos):
    """The bounds tests/test_mega_step.py holds the TPU kernel to: logits
    2e-2 relative to their max, alignment 2e-3, the written k/v rows 5e-2;
    every other cache slot untouched. Layer 0's rows take the same LN1 and
    int8 product of the same token on both sides, so they are held to one
    bf16 rounding (2**-7 of the value) plus 2**-10 of the row's largest
    value for an LN1 output that rounds the other way."""
    model, cache = _k3_case(cuda_device, slots)
    token = torch.tensor([[17]], device=cuda_device)
    copies = [tw.DecodeCache(cache.self_k.clone(), cache.self_v.clone(),
                             cache.cross_k, cache.cross_v) for _ in range(2)]
    before = tm.MEGA_LAUNCHES
    lk, ck, ak = tm.mega_decoder_step(model, token, pos, copies[0])
    torch.cuda.synchronize()
    assert tm.MEGA_LAUNCHES == before + 1
    lp, cp, ap = tm.mega_decoder_step_plain(model, token, pos, copies[1])
    assert lk.shape == (1, 500) and ak.shape == (1, 2, 96)
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    assert rel < 2e-2
    assert (ak - ap).abs().max().item() < 2e-3
    keep = torch.arange(slots, device=cuda_device) != pos
    for got, ref, orig in zip((ck.self_k, ck.self_v), (cp.self_k, cp.self_v),
                              (cache.self_k, cache.self_v)):
        assert (got[:, :, :, pos].float() - ref[:, :, :, pos].float()).abs().max() < 5e-2
        g0, r0 = got[0, 0, :, pos].float(), ref[0, 0, :, pos].float()
        bound = (2 ** -7 * torch.maximum(g0.abs(), r0.abs())
                 + 2 ** -10 * r0.abs().max())
        assert ((g0 - r0).abs() <= bound).all()
        assert torch.equal(got[:, :, :, keep], orig[:, :, :, keep])


def test_mega_step_kernel_one_layer_agrees_exactly(cuda_device):
    """On one layer kernel and plain step round at the same points; a step
    in which no value rounds to the other bf16 neighbour agrees to f32
    noise. Among eight steps the best must agree to 1e-5 (a fault such as
    a dropped bias moves every step) and every one to 1e-2 (one value that
    rounds the other way spreads through the layer's later roundings)."""
    model, cache = _k3_case(cuda_device, 60)
    mp = model.mega._replace(**{f: getattr(model.mega, f)[:1] for f in (
        "qkv_w", "o_w", "cq_w", "co_w", "fc1_w", "fc2_w", "smalls")})
    arch = dataclasses.replace(K3_ARCH, decoder_layers=1)
    ck, cv = (tq.QuantizedKV(kv.q[:1], kv.s[:1])
              for kv in (cache.cross_k, cache.cross_v))
    rels = []
    for pos in (3, 10, 17, 25, 33, 41, 50, 59):
        x = tw.embed_tokens(model, torch.tensor([[17 + pos]], device=cuda_device),
                            pos)[:, 0]
        lk, _ = tm.mega_step(mp, x, pos, tw.DecodeCache(
            cache.self_k[:1].clone(), cache.self_v[:1].clone(), ck, cv), arch)
        lp, _ = tm.mega_step_plain(mp, x, pos, tw.DecodeCache(
            cache.self_k[:1].clone(), cache.self_v[:1].clone(), ck, cv), arch)
        rels.append(((lk - lp).abs().max() / lp.abs().max()).item())
    assert max(rels) < 1e-2 and min(rels) < 1e-5, rels


@pytest.mark.parametrize("t_enc,slots,pos,w", [(1501, 61, 60, 1), (97, 200, 150, 1),
                                               (97, 64, 57, 5), (1500, 200, 140, 16)])
def test_mega_kernels_take_ragged_chunks(cuda_device, t_enc, slots, pos, w):
    """T and the window's slots (pos + W) that are not multiples of the
    attention chunks (ops.mega_step.attention_chunks on this card's SM
    count; past SELF_MIN_CHUNK slots the self-attention splits too): K3
    (W = 1) or K4 against the plain version, logits 2e-2 relative to their
    max, alignment 2e-3, every other slot untouched. Positions past the
    position table take its last rows on both sides."""
    model, cache = _k3_case(cuda_device, slots, t_enc=t_enc)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, least in ((t_enc, 1), (pos + w, tm.SELF_MIN_CHUNK)):
        length, count = tm.attention_chunks(n, 6, sms, least)
        assert n % length != 0 or count == 1, (n, length)
    tokens = torch.arange(17, 17 + w, device=cuda_device)[None]
    copies = [tw.DecodeCache(cache.self_k.clone(), cache.self_v.clone(),
                             cache.cross_k, cache.cross_v) for _ in range(2)]
    if w == 1:
        lk, ck, ak = tm.mega_decoder_step(model, tokens, pos, copies[0])
        lp, cp, ap = tm.mega_decoder_step_plain(model, tokens, pos, copies[1])
        assert (ak - ap).abs().max().item() < 2e-3
    else:
        lk, ck, _ = tm.mega_decoder_verify(model, tokens, pos, copies[0])
        lp, cp, _ = tm.mega_decoder_verify(model, tokens, pos, copies[1],
                                           plain=True)
    torch.cuda.synchronize()
    assert ((lk - lp).abs().max() / lp.abs().max()).item() < 2e-2
    keep = torch.ones(slots, dtype=torch.bool, device=cuda_device)
    keep[pos:pos + w] = False
    for got, orig in zip((ck.self_k, ck.self_v), (cache.self_k, cache.self_v)):
        assert torch.equal(got[:, :, :, keep], orig[:, :, :, keep])


def test_mega_step_kernel_rejects_bad_input(cuda_device):
    model, cache = _k3_case(cuda_device, 8)
    token = torch.tensor([[17]], device=cuda_device)
    with pytest.raises(ValueError, match="position"):
        tm.mega_decoder_step(model, token, 8, cache)
    f32 = tw.DecodeCache(cache.self_k.float(), cache.self_v.float(),
                         cache.cross_k, cache.cross_v)
    with pytest.raises(ValueError, match="bf16"):
        tm.mega_decoder_step(model, token, 4, f32)


@pytest.mark.parametrize("w", [1, 5, 16])
@pytest.mark.parametrize("pos", [0, 27])
def test_mega_verify_kernel_matches_plain(cuda_device, w, pos):
    """K4 against its plain version, K3's bounds: logits 2e-2 relative to
    their max, the window's k/v rows 5e-2, layer 0's rows within one bf16
    rounding; every slot outside the window untouched."""
    slots = 60
    model, cache = _k3_case(cuda_device, slots)
    tokens = torch.arange(17, 17 + w, device=cuda_device)[None]
    copies = [tw.DecodeCache(cache.self_k.clone(), cache.self_v.clone(),
                             cache.cross_k, cache.cross_v) for _ in range(2)]
    before = tm.MEGA_VERIFY_LAUNCHES
    lk, ck, ak = tm.mega_decoder_verify(model, tokens, pos, copies[0])
    torch.cuda.synchronize()
    assert tm.MEGA_VERIFY_LAUNCHES == before + 1
    lp, cp, _ = tm.mega_decoder_verify(model, tokens, pos, copies[1],
                                       plain=True)
    assert lk.shape == (1, w, 500) and ak.shape == (1, w, 2, 96)
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    assert rel < 2e-2
    win = slice(pos, pos + w)
    keep = torch.ones(slots, dtype=torch.bool, device=cuda_device)
    keep[win] = False
    for got, ref, orig in zip((ck.self_k, ck.self_v), (cp.self_k, cp.self_v),
                              (cache.self_k, cache.self_v)):
        assert (got[:, :, :, win].float() - ref[:, :, :, win].float()).abs().max() < 5e-2
        g0, r0 = got[0, 0, :, win].float(), ref[0, 0, :, win].float()
        bound = (2 ** -7 * torch.maximum(g0.abs(), r0.abs())
                 + 2 ** -10 * r0.abs().max())
        assert ((g0 - r0).abs() <= bound).all()
        assert torch.equal(got[:, :, :, keep], orig[:, :, :, keep])


@pytest.mark.parametrize("w,d_ff", [(8, 1536), (16, 5120)])
def test_mega_verify_rows_are_k3_steps(cuda_device, w, d_ff):
    """K4's row j and K3's step at slot pos + j share every rounding point
    and order of sums: on one layer, as K3's own one-layer check, every row
    within 1e-2 of the step and the best within 1e-5. At 16 rows of d_ff
    5120 (large-v3's) K4 stages fc2's input in two column chunks."""
    model, cache = _k3_case(cuda_device, 60, d_ff=d_ff)
    mp = model.mega._replace(**{f: getattr(model.mega, f)[:1] for f in (
        "qkv_w", "o_w", "cq_w", "co_w", "fc1_w", "fc2_w", "smalls")})
    arch = dataclasses.replace(K3_ARCH, decoder_layers=1)
    ck, cv = (tq.QuantizedKV(kv.q[:1], kv.s[:1])
              for kv in (cache.cross_k, cache.cross_v))
    pos = 21
    tokens = torch.arange(40, 40 + w, device=cuda_device)[None]
    x = tw.embed_tokens(model, tokens, pos)[0]
    lv = tm.mega_verify(mp, x, pos, tw.DecodeCache(
        cache.self_k[:1].clone(), cache.self_v[:1].clone(), ck, cv), arch)
    steps = tw.DecodeCache(cache.self_k[:1].clone(), cache.self_v[:1].clone(),
                           ck, cv)
    rels = []
    for j in range(w):
        ls, _ = tm.mega_step(mp, x[j:j + 1], pos + j, steps, arch)
        rels.append(((lv[j] - ls[0]).abs().max() / ls.abs().max()).item())
    assert max(rels) < 1e-2 and min(rels) < 1e-5, rels


def test_mega_verify_kernel_rejects_bad_input(cuda_device):
    model, cache = _k3_case(cuda_device, 8)
    with pytest.raises(ValueError, match="window"):
        tm.mega_decoder_verify(model, torch.zeros(1, 17, dtype=torch.long,
                                                  device=cuda_device), 0, cache)
    with pytest.raises(ValueError, match="outside"):
        tm.mega_decoder_verify(model, torch.zeros(1, 4, dtype=torch.long,
                                                  device=cuda_device), 5, cache)


@pytest.mark.parametrize("slots,pos,w", [(448, 9, 1), (448, 150, 1), (60, 59, 1),
                                         (448, 140, 5), (60, 0, 16)])
def test_mega_device_position_matches_host_plan(cuda_device, slots, pos, w):
    """K3 (W = 1) and K4 with the slot read from device memory and the
    self-attention planned for the whole cache (chunks past pos + W
    neutral) give the bits of the launch planned at pos + W from a host
    int, cache included, and the plain version's bounds."""
    model, cache = _k3_case(cuda_device, slots)
    mp = model.mega
    tokens = torch.arange(17, 17 + w, device=cuda_device)[None]
    x = tw.embed_tokens_at(model, tokens,
                           torch.full((1,), pos, device=cuda_device))[0]
    copies = [tw.DecodeCache(cache.self_k.clone(), cache.self_v.clone(),
                             cache.cross_k, cache.cross_v) for _ in range(3)]
    slot = torch.tensor([pos], dtype=torch.int32, device=cuda_device)
    if w == 1:
        lh, ah = tm.mega_step(mp, x, pos, copies[0], K3_ARCH)
        ld, ad = tm.mega_step(mp, x, slot, copies[1], K3_ARCH)
        lp, ap = tm.mega_step_plain(mp, x, pos, copies[2], K3_ARCH)
        assert torch.equal(ah, ad)
        assert (ad - ap).abs().max().item() < 2e-3
    else:
        lh = tm.mega_verify(mp, x, pos, copies[0], K3_ARCH)
        ld = tm.mega_verify(mp, x, slot, copies[1], K3_ARCH)
        lp = tm.mega_verify_plain(mp, x, pos, copies[2], K3_ARCH)
    torch.cuda.synchronize()
    assert torch.equal(lh, ld)
    assert torch.equal(copies[0].self_k, copies[1].self_k)
    assert torch.equal(copies[0].self_v, copies[1].self_v)
    assert _rel(ld, lp) < 2e-2


def test_mega_device_position_outside_its_bound_sets_the_error(cuda_device):
    """A device slot with pos + W past the bound the launch was planned for
    (the cache's length) or below 0 writes nothing and sets the error word:
    an eager launch raises; with ``check=False`` the word waits for
    ``raise_position_errors``, which clears it."""
    model, cache = _k3_case(cuda_device, 60)
    mp = model.mega
    x = tw.embed_tokens(model, torch.arange(17, 20, device=cuda_device)[None],
                        0)[0]
    before = (cache.self_k.clone(), cache.self_v.clone())

    def slot(pos):
        return torch.tensor([pos], dtype=torch.int32, device=cuda_device)

    with pytest.raises(ValueError, match="outside the bound"):
        tm.mega_step(mp, x[:1], slot(60), cache, K3_ARCH)
    tm.mega_verify(mp, x, slot(58), cache, K3_ARCH, check=False)
    with pytest.raises(ValueError, match="outside the bound"):
        tm.raise_position_errors(cuda_device)
    tm.raise_position_errors(cuda_device)
    with pytest.raises(ValueError, match="outside the bound"):
        tm.mega_step(mp, x[:1], slot(-1), cache, K3_ARCH)
    assert torch.equal(cache.self_k, before[0])
    assert torch.equal(cache.self_v, before[1])
    ok, _ = tm.mega_step(mp, x[:1], slot(59), cache, K3_ARCH)
    assert torch.isfinite(ok).all()
    ok = tm.mega_verify(mp, x, slot(57), cache, K3_ARCH)
    assert torch.isfinite(ok).all()


@pytest.mark.parametrize("route", ["k3", "plain"])
def test_captured_greedy_steps_replay_the_eager_steps(cuda_device, route):
    """A run of four greedy steps captured as a CUDA graph
    (``engine.graphs.StepGraph``) and replayed from the loop's device state
    gives, bit for bit, what the same loop's eager steps give: tokens,
    logprobs, alignment and the cache; through K3 (batch 1, bf16, packed:
    each replay counts its four K3 launches) and through the plain bf16
    step."""
    from thewhisper_tpu_torch.engine.decode import GreedyLoop
    from thewhisper_tpu_torch.engine.graphs import StepGraph

    model, cache = _k3_case(cuda_device, 4 + 13)
    if route == "plain":
        model.mega = None
    prompt = torch.tensor([[1, 2, 3, 4]], device=cuda_device)
    results = []
    for graphed in (False, True):
        fresh = tw.make_cache(K3_ARCH, 1, 4 + 13, cache.cross_k, cache.cross_v,
                              dtype=torch.bfloat16)
        loop = GreedyLoop(model, fresh, 4, 13, -1, capture_alignment=True)
        assert loop.mega == (route == "k3")
        replay = None
        if graphed:
            loop.park()
            graph = StepGraph(lambda: loop.steps(4), lambda: loop.steps(1),
                              cuda_device)
            assert graph.launches == (4 if route == "k3" else 0)
            replay = graph.replay
        before = tm.MEGA_LAUNCHES
        loop.start(prompt)
        steps = loop.run(4, replay=replay)
        torch.cuda.synchronize()
        assert steps == 12
        if route == "k3":
            assert tm.MEGA_LAUNCHES - before == 12
        # Slots 4 .. 15 the twelve steps wrote (the graph's warm-up step
        # wrote the parked slot 16).
        results.append((loop.result(), fresh.self_k[:, :, :, :16].clone(),
                        fresh.self_v[:, :, :, :16].clone()))
    (a, ak, av), (b, bk, bv) = results
    for name in ("tokens", "num_generated", "sum_logprob", "align",
                 "token_logprobs", "no_speech_prob"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(ak, bk) and torch.equal(av, bv)


@pytest.mark.parametrize("route", ["k4", "plain"])
def test_captured_spec_rounds_replay_the_eager_rounds(cuda_device, route):
    """Speculative rounds (ngram drafts, W = 3) captured two to a CUDA
    graph and replayed from the loop's device state give, bit for bit,
    what the same rounds give eagerly: every output, the round count and
    the cache; through K4 at a device window position (batch 1, bf16,
    packed: each replay counts its two K4 launches and no K3) and through
    the plain verify."""
    from thewhisper_tpu_torch.engine.graphs import StepGraph
    from thewhisper_tpu_torch.engine.speculative import SpecLoop

    model, cache = _k3_case(cuda_device, 4 + 13 + 4)
    if route == "plain":
        model.mega = None
    prompt = torch.tensor([[1, 2, 3, 4]], device=cuda_device)
    results = []
    for graphed in (False, True):
        fresh = tw.make_cache(K3_ARCH, 1, 4 + 13 + 4, cache.cross_k,
                              cache.cross_v, dtype=torch.bfloat16)
        loop = SpecLoop(model, None, fresh, None, 4, 13, -1, 3,
                        ngram_draft=True)
        assert loop.mega == (route == "k4")
        loop.park()
        replay = None
        if graphed:
            graph = StepGraph(lambda: loop.steps(2), lambda: loop.steps(1),
                              cuda_device)
            assert graph.verify_launches == (2 if route == "k4" else 0)
            assert graph.launches == 0
            replay = graph.replay
        else:
            loop.steps(1)          # the graph's warm-up round, eagerly
        before = tm.MEGA_VERIFY_LAUNCHES
        loop.start(prompt)
        calls = loop.run(2, replay=replay)
        res = loop.result()
        if route == "k4":
            assert tm.MEGA_VERIFY_LAUNCHES - before == calls
        assert 0 < res.rounds <= calls
        results.append((res, fresh.self_k.clone(), fresh.self_v.clone()))
    (a, ak, av), (b, bk, bv) = results
    for name in ("tokens", "num_generated", "sum_logprob", "token_logprobs",
                 "no_speech_prob"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.rounds == b.rounds
    assert torch.equal(ak, bk) and torch.equal(av, bv)


def test_sampled_graph_replays_the_eager_steps(cuda_device):
    """Sampled steps captured as a CUDA graph that registers the generator
    and reads the temperature from a device scalar (as the engine's
    sampled program does), replayed from the loop's state: for two seeds
    at temperature 1 and one at 0.5 the tokens and numbers the same steps
    draw eagerly, bit for bit, through K3 (batch 1, bf16, packed)."""
    from thewhisper_tpu_torch.engine.decode import GreedyLoop
    from thewhisper_tpu_torch.engine.graphs import StepGraph

    model, cache = _k3_case(cuda_device, 4 + 13)
    prompt = torch.tensor([[1, 2, 3, 4]], device=cuda_device)
    gen = torch.Generator(cuda_device)
    temperature = torch.ones((), device=cuda_device)
    kw = {"temperature": temperature, "generator": gen}
    loops = [GreedyLoop(model, tw.make_cache(K3_ARCH, 1, 4 + 13, cache.cross_k,
                                             cache.cross_v, dtype=torch.bfloat16),
                        4, 13, -1, capture_alignment=True) for _ in range(2)]
    loops[1].park()
    graph = StepGraph(lambda: loops[1].steps(4, **kw),
                      lambda: loops[1].steps(1, **kw), cuda_device, gen)
    assert graph.launches == 4
    tokens = []
    for seed, t in ((5, 1.0), (6, 1.0), (5, 0.5)):
        temperature.fill_(t)
        out = []
        for loop, replay in zip(loops, (None, graph.replay)):
            gen.manual_seed(seed)
            loop.start(prompt, temperature, gen)
            assert loop.run(4, replay=replay, **kw) == 12
            out.append(loop.result())
        for name in ("tokens", "num_generated", "sum_logprob", "align",
                     "token_logprobs", "no_speech_prob"):
            assert torch.equal(getattr(out[0], name), getattr(out[1], name)), name
        tokens.append(out[0].tokens.clone())
    assert not torch.equal(tokens[0], tokens[1])


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s", [(1, 2, 1024), (2, 3, 1536), (1, 1, 512),
                                   (2, 20, 1536)])
def test_attention_control_kernel_matches_plain(cuda_device, dtype, b, h, s):
    """P1 against its plain version, relative to the largest value (outputs
    reach the thousands): f32 1e-5 (the same f32 math, summed in another
    order); bf16 1e-2 (a score summed in another order may round p to the
    other bf16 neighbour, and the output rounds to bf16)."""
    g = torch.Generator(device="cpu").manual_seed(3)
    q, k, v = (torch.randn(b, h, s, 64, generator=g).to(cuda_device, dtype)
               for _ in range(3))
    before = tac.CONTROL_LAUNCHES
    out = tac.attention_control(q, k, v)
    torch.cuda.synchronize()
    assert tac.CONTROL_LAUNCHES == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = tac.attention_control_plain(q, k, v)
    assert _rel(out, ref) < (1e-5 if dtype == torch.float32 else 1e-2)


def _control_case(device, dtype, b=1, h=20, s=1536, q_scale=1.0, seed=5):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, 64, generator=g) for _ in range(3))
    return [t.to(device, dtype) for t in (q * q_scale, k, v)]


def test_attention_control_kernel_bf16_rounds_p_as_plain(cuda_device):
    """q scaled by 4: scores span hundreds and p rounds to bf16 with an
    error of up to 2**-9 of its value. Kernel and plain version round the
    same p at the same point, so the outputs differ only where a score
    summed in another order rounds p (or the output) the other way: within
    1e-2 of the largest value and, over the whole output, 5e-4 relative L2
    (a p rounded toward zero instead of to nearest gives about 5e-3)."""
    q, k, v = _control_case(cuda_device, torch.bfloat16, q_scale=4.0)
    out = tac.attention_control(q, k, v).float()
    ref = tac.attention_control_plain(q, k, v).float()
    assert _rel(out, ref) < 1e-2
    assert ((out - ref).norm() / ref.norm()).item() < 5e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_control_kernel_row_sums_match_plain(cuda_device, dtype):
    """l, the row sum of the unrounded p, never reaches the output (every
    p <= 0, so the division is by 1); read through ``row_sums`` it agrees
    with the plain version's to f32 summation order, 1e-5 of its largest
    magnitude (summing the bf16-rounded p instead moves it about 1e-4)."""
    q, k, v = _control_case(cuda_device, dtype, b=2, h=4)
    got = torch.empty(q.shape[:-1], device=cuda_device)
    want = torch.empty_like(got)
    tac.attention_control(q, k, v, row_sums=got)
    tac.attention_control_plain(q, k, v, row_sums=want)
    torch.cuda.synchronize()
    assert want.max().item() <= 0
    assert _rel(got, want) < 1e-5


def test_attention_control_kernel_rejects_bad_input(cuda_device):
    x = torch.zeros(1, 2, 1000, 64, device=cuda_device)
    with pytest.raises(ValueError, match="512"):
        tac.attention_control(x, x, x)
    y = torch.zeros(1, 2, 512, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tac.attention_control(y, y, y)
    flat = torch.zeros(2 * 512 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 512, 64)                      # base + 2 bytes
    ok = torch.zeros(1, 2, 512, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        tac.attention_control(shifted, ok, ok)
    with pytest.raises(ValueError, match="row_sums"):
        tac.attention_control(ok, ok, ok, row_sums=torch.zeros(1, 2, 512, device=cuda_device,
                                                               dtype=torch.bfloat16))


def _mlp_case(device, n_layers=2, d=256, f=1024, seed=0):
    """The probe's operands, random LayerNorm parameters included (a kernel
    that misreads one would pass with unit scales and zero shifts), and
    their pack for the kernel."""
    from thewhisper_tpu_torch.tools.gemv_chain_probe import make_inputs, operands

    g = torch.Generator(device="cpu").manual_seed(seed)
    p = make_inputs(n_layers, d, f, g, torch.device("cpu"))
    ops = [t.to(device) for t in operands(p)]
    return p["x"].to(device), ops, tmc.pack_mlp_weights(ops[6], ops[7])


def _check_mlp_chain(device, n_layers, d, f):
    """P2 against its plain version within 1e-2 of the largest value (the
    same bf16 rounding points, f32 sums in another order); P3 over every
    layer in turn equals P2 bit for bit (every block's rows and sum order
    are independent of the layer range); a second launch gives the same
    bits."""
    x, ops, packed = _mlp_case(device, n_layers, d, f)
    before = tmc.MLP_CHAIN_LAUNCHES, tmc.MLP_LAYER_LAUNCHES
    chain = tmc.mlp_chain(x, *ops, packed=packed)
    y = x
    for l in range(n_layers):
        y = tmc.mlp_layer(y, l, *ops, packed=packed)
    torch.cuda.synchronize()
    assert (tmc.MLP_CHAIN_LAUNCHES, tmc.MLP_LAYER_LAUNCHES) == (
        before[0] + 1, before[1] + n_layers)
    assert chain.shape == x.shape and chain.dtype == torch.bfloat16
    assert _rel(chain, tmc.mlp_chain_plain(x, *ops)) < 1e-2
    assert torch.equal(y, chain)
    assert torch.equal(tmc.mlp_chain(x, *ops, packed=packed), chain)  # deterministic


@pytest.mark.parametrize("n_layers", [1, 3])
def test_mlp_chain_kernel_matches_plain(cuda_device, n_layers):
    _check_mlp_chain(cuda_device, n_layers, 256, 1024)


def test_mlp_chain_kernel_matches_plain_at_probe_widths(cuda_device):
    """L = 2 at d_model 1280, d_ff 5120: fc2's 1280 rows over the card's
    132 blocks leave each a tile of 9 or 10 rows."""
    _check_mlp_chain(cuda_device, 2, 1280, 5120)


def test_mlp_chain_kernel_last_layer_alone(cuda_device):
    """P3 over the last layer alone (l0 = L - 1) against its plain layer,
    and bit for bit against P2 over a one-layer stack of that layer."""
    x, ops, packed = _mlp_case(cuda_device, 3, seed=4)
    got = tmc.mlp_layer(x, 2, *ops, packed=packed)
    last = [t[2:] for t in ops]
    alone = tmc.mlp_chain(x, *last, packed=tmc.pack_mlp_weights(last[6], last[7]))
    torch.cuda.synchronize()
    assert _rel(got, tmc.mlp_layer_plain(x, 2, *ops)) < 1e-2
    assert torch.equal(got, alone)


def _mlp_plain_without(x, ops, rounding):
    """The plain layer 0 with one of its bf16 roundings left out: of GELU's
    input ("gelu") or of y before the residual ("residual")."""
    ln_s, ln_b, s1, b1, s2, b2, w1, w2 = ops
    q = torch.nn.functional.layer_norm(x.float(), x.shape[-1:], ln_s[0], ln_b[0],
                                       1e-5).to(x.dtype)
    h = torch.matmul(q.float(), w1[0].float()) * s1[0] + b1[0]
    h = torch.nn.functional.gelu(h if rounding == "gelu" else h.to(x.dtype),
                                 approximate="tanh").to(x.dtype)
    y = torch.matmul(h.float(), w2[0].float()) * s2[0] + b2[0]
    return (x.float() + (y if rounding == "residual" else y.to(x.dtype).float())).to(x.dtype)


@pytest.mark.parametrize("rounding", ["gelu", "residual"])
def test_mlp_chain_kernel_rounds_as_plain(cuda_device, rounding):
    """The kernel rounds where the plain version does: at L = 1 and the
    probe's widths its relative L2 distance from the plain version is at
    most half that of the plain version with one rounding left out (the
    CPU emulation of the kernel's order: 2e-4 or less against about 3e-3,
    tests/test_torch_mlp_schedule.py)."""
    x, ops, packed = _mlp_case(cuda_device, 1, 1280, 5120, seed=21)
    plain = tmc.mlp_chain_plain(x, *ops)
    got = tmc.mlp_chain(x, *ops, packed=packed)
    torch.cuda.synchronize()

    def l2(a):
        return ((a.float() - plain.float()).norm() / plain.float().norm()).item()

    assert l2(got) <= 0.5 * l2(_mlp_plain_without(x, ops, rounding))


def test_mlp_chain_kernel_rejects_bad_input(cuda_device):
    x, ops, packed = _mlp_case(cuda_device, 1, d=192, f=512)
    with pytest.raises(ValueError, match="multiples"):
        tmc.mlp_chain(x, *ops, packed=packed)
    x, ops, packed = _mlp_case(cuda_device, 2)
    with pytest.raises(ValueError, match="outside"):
        tmc.mlp_layer(x, 2, *ops, packed=packed)
    # The kernel reads the packed weights only: a call without them, or
    # with a pack of other weights (other shapes, or the same shapes in
    # other storage), is refused.
    with pytest.raises(ValueError, match="pack_mlp_weights"):
        tmc.mlp_chain(x, *ops)
    with pytest.raises(ValueError, match="stale"):
        tmc.mlp_chain(x, *ops, packed=_mlp_case(cuda_device, 3)[2])
    with pytest.raises(ValueError, match="stale"):
        tmc.mlp_layer(x, 0, *ops, packed=_mlp_case(cuda_device, 2, seed=1)[2])


@pytest.mark.parametrize("shape,pos", [((448, 1280), 13), ((32, 448, 1280), 14335),
                                       ((32, 448, 1280), 0)])
def test_write_row_kernel_equals_plain(cuda_device, shape, pos):
    g = torch.Generator(device="cpu").manual_seed(pos)
    cache = torch.randn(shape, generator=g).to(cuda_device, torch.bfloat16)
    row = torch.randn(1, shape[-1], generator=g).to(cuda_device, torch.bfloat16)
    ref = tcw.write_row_plain(cache.clone(), pos, row)
    before = tcw.ROW_LAUNCHES
    got = tcw.write_row(cache, pos, row)
    torch.cuda.synchronize()
    assert tcw.ROW_LAUNCHES == before + 1 and got.data_ptr() == cache.data_ptr()
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="outside"):
        tcw.write_row(cache, cache.numel() // shape[-1], row)


@pytest.mark.parametrize("pos", [0, 7, 227])
def test_write_column_kernel_equals_plain(cuda_device, pos):
    g = torch.Generator(device="cpu").manual_seed(pos)
    cache = torch.randn(128, 1280, 228, generator=g).to(cuda_device, torch.bfloat16)
    col = torch.randn(128, 1280, 1, generator=g).to(cuda_device, torch.bfloat16)
    ref = tcw.write_column_plain(cache.clone(), col, pos)
    before = tcw.COLUMN_LAUNCHES
    got = tcw.write_column(cache, col, pos)
    torch.cuda.synchronize()
    assert tcw.COLUMN_LAUNCHES == before + 1 and got.data_ptr() == cache.data_ptr()
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="outside"):
        tcw.write_column(cache, col, 228)


WHISPER_WIDTHS = (384, 512, 768, 1024, 1280)


def _slot(pos, kind, device):
    return pos if kind == "host" else torch.tensor([pos], dtype=torch.int32, device=device)


@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("d", WHISPER_WIDTHS)
def test_write_row_kernel_every_whisper_width(cuda_device, d, kind):
    """Every 16-byte chunk of the row lands, at a host or a device slot,
    and nothing else changes (slot 300 of layer 1 of a (2, 448, D) cache)."""
    g = torch.Generator(device="cpu").manual_seed(d)
    cache = torch.randn(2, 448, d, generator=g).to(cuda_device, torch.bfloat16)
    row = torch.randn(d, generator=g).to(cuda_device, torch.bfloat16)
    ref = tcw.write_row_plain(cache.clone(), 748, row)
    before = tcw.ROW_LAUNCHES
    got = tcw.write_row(cache, _slot(748, kind, cuda_device), row)
    torch.cuda.synchronize()
    assert tcw.ROW_LAUNCHES == before + 1 and got.data_ptr() == cache.data_ptr()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("pos", [0, 7, 227])
def test_write_column_kernel_device_slot(cuda_device, pos):
    g = torch.Generator(device="cpu").manual_seed(pos + 1)
    cache = torch.randn(128, 1280, 228, generator=g).to(cuda_device, torch.bfloat16)
    col = torch.randn(128, 1280, 1, generator=g).to(cuda_device, torch.bfloat16)
    ref = tcw.write_column_plain(cache.clone(), col, pos)
    before = tcw.COLUMN_LAUNCHES
    got = tcw.write_column(cache, col, _slot(pos, "device", cuda_device))
    torch.cuda.synchronize()
    assert tcw.COLUMN_LAUNCHES == before + 1 and got.data_ptr() == cache.data_ptr()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("kernel", ["write_row", "write_column"])
def test_write_row_and_write_column_read_the_slot_at_replay(cuda_device, kernel):
    """16 writes captured in a CUDA graph, each reading slots[i]; the slots
    refilled on the card after capture; the replay writes at the new slots."""
    g = torch.Generator(device="cpu").manual_seed(5)
    if kernel == "write_row":
        cache = torch.zeros(448, 1280, dtype=torch.bfloat16, device=cuda_device)
        src = torch.randn(16, 1280, generator=g).to(cuda_device, torch.bfloat16)
        write, plain, n = tcw.write_row, tcw.write_row_plain, 448
    else:
        cache = torch.zeros(128, 1280, 228, dtype=torch.bfloat16, device=cuda_device)
        src = torch.randn(16, 128, 1280, 1, generator=g).to(cuda_device, torch.bfloat16)
        n = 228

        def write(c, pos, x):
            return tcw.write_column(c, x, pos)

        def plain(c, pos, x):
            return tcw.write_column_plain(c, x, pos)
    slots = torch.arange(16, dtype=torch.int32, device=cuda_device)
    views = slots.split(1)
    graph = capture(lambda: [write(cache, views[i], src[i]) for i in range(16)])
    new = torch.randperm(n, generator=g)[:16]
    slots.copy_(new.to(cuda_device, torch.int32))
    cache.zero_()
    graph.replay()
    ref = torch.zeros_like(cache)
    for i, pos in enumerate(new.tolist()):
        plain(ref, pos, src[i])
    torch.cuda.synchronize()
    assert torch.equal(cache, ref)


@pytest.mark.parametrize("mode", ["eager", "graph"])
def test_write_row_relay_after_write_column(cuda_device, mode):
    """Programmatic launches keep their order: P5 writes column 7 of A,
    P4 copies row j of A's (R F, 256) view (a row crossing column 7) into
    slot k of B, P4 copies B's row k into slot k of C; 16 rounds. Eager,
    the launches queue behind a sleep kernel so the card runs them back to
    back. A kernel that read before ``griddepcontrol.wait`` would copy a
    row before its predecessor wrote it."""
    g = torch.Generator(device="cpu").manual_seed(9)
    a0 = torch.randn(128, 1280, 256, generator=g).to(cuda_device, torch.bfloat16)
    cols = torch.randn(16, 128, 1280, 1, generator=g).to(cuda_device, torch.bfloat16)
    rf = 128 * 1280
    js = [rf - 1 - k * (rf // 16) for k in range(16)]

    def relay(a, b, c, column, row):
        for k in range(16):
            column(a, cols[k], 7)
            row(b, k, a.view(rf, 256)[js[k]])
            row(c, k, b[k])

    def fresh():
        return [a0.clone(), torch.zeros(16, 256, dtype=torch.bfloat16, device=cuda_device),
                torch.zeros(16, 256, dtype=torch.bfloat16, device=cuda_device)]
    want, got = fresh(), fresh()
    relay(*want, tcw.write_column_plain, tcw.write_row_plain)
    torch.cuda.synchronize()
    if mode == "eager":
        torch.cuda._sleep(10_000_000)
        relay(*got, tcw.write_column, tcw.write_row)
    else:
        graph = capture(lambda: relay(*got, tcw.write_column, tcw.write_row))
        got[0].copy_(a0)
        got[1].zero_()
        got[2].zero_()
        graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_write_row_and_write_column_refuse_bad_input(cuda_device):
    before = (tcw.ROW_LAUNCHES, tcw.COLUMN_LAUNCHES)
    cache = torch.zeros(4, 100, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        tcw.write_row(cache, 1, torch.zeros(100, dtype=torch.bfloat16, device=cuda_device))
    cache = torch.zeros(4, 256, dtype=torch.bfloat16, device=cuda_device)
    buf = torch.zeros(512, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        tcw.write_row(cache, 1, buf[1:257])
    row = buf[:256]
    for bad in (torch.tensor([1], device=cuda_device),
                torch.tensor([1], dtype=torch.int32),
                torch.tensor([1, 2], dtype=torch.int32, device=cuda_device)):
        with pytest.raises(ValueError, match="slot tensor"):
            tcw.write_row(cache, bad, row)
    cache = torch.zeros(2, 64, 16, dtype=torch.bfloat16, device=cuda_device)
    col = torch.zeros(2, 64, 1, dtype=torch.bfloat16, device=cuda_device)
    for bad in (torch.tensor([1], device=cuda_device), torch.tensor([1], dtype=torch.int32)):
        with pytest.raises(ValueError, match="slot tensor"):
            tcw.write_column(cache, col, bad)
    with pytest.raises(ValueError, match="multiple of 8"):
        tcw.write_column(torch.zeros(1, 4, 16, dtype=torch.bfloat16, device=cuda_device),
                         torch.zeros(1, 4, 1, dtype=torch.bfloat16, device=cuda_device), 0)
    assert (tcw.ROW_LAUNCHES, tcw.COLUMN_LAUNCHES) == before


_TRAP_CHILD = """
import sys, torch
from thewhisper_tpu_torch.ops import cache_write as cw
dev = torch.device("cuda", 0)
kernel, pos = sys.argv[1], int(sys.argv[2])
n = 64 * 256
buf = torch.zeros(3 * n, dtype=torch.bfloat16, device=dev)   # guard, cache, guard
row = torch.ones(256, dtype=torch.bfloat16, device=dev)
col = torch.ones(16, 16, 1, dtype=torch.bfloat16, device=dev)
if kernel == "write_row":
    cache = buf[n:2 * n].view(64, 256)
    write = lambda slot: cw.write_row(cache, slot, row)
else:
    cache = buf[n:2 * n].view(16, 16, 64)
    write = lambda slot: cw.write_column(cache, col, slot)
write(torch.tensor([5], dtype=torch.int32, device=dev))
want = buf.clone()
torch.cuda.synchronize()
print("in range: written", bool(want[n:2 * n].any()), flush=True)
write(torch.tensor([pos], dtype=torch.int32, device=dev))
try:
    torch.cuda.synchronize()
except RuntimeError as err:
    print("trapped:", str(err).splitlines()[0], flush=True)
    sys.exit(3)
print("no trap; memory changed:", not torch.equal(buf, want), flush=True)
"""


@pytest.mark.parametrize("kernel,pos", [("write_row", 64), ("write_row", -1),
                                        ("write_column", 64), ("write_column", -7)])
def test_write_row_and_write_column_device_slot_outside_traps(cuda_device, kernel, pos):
    """A device slot outside the cache traps in the kernel, before any
    thread stores: the child's next synchronise fails (a trap ends the CUDA
    context, so it runs in its own process). The cache sits between two
    guards; a kernel without the range check writes into one and the child
    exits 0."""
    root = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_TRAP_CHILD), kernel,
                           str(pos)], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert "in range: written True" in proc.stdout, proc.stdout + proc.stderr
    assert proc.returncode == 3 and "trapped:" in proc.stdout, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# Q4: the int4 weight-only linear ("S4")
# ---------------------------------------------------------------------------


def _q4_operands(dev, m, n, k, dtype, bias=True, seed=0):
    """x (m, k), a packed (n, k / 2) weight quantized from a random one,
    its scales and a bias, as ``Int4Linear.from_linear`` makes them."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(n, k, generator=g) * k ** -0.5
    q, s = tq.quantize_weight(w, bits=4)
    x = torch.randn(m, k, generator=g).to(dtype)
    b = (0.1 * torch.randn(n, generator=g)).to(dtype) if bias else None
    return (x.to(dev), tq.pack_int4(q).to(dev), s.to(dev),
            None if b is None else b.to(dev))


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


# Both bf16 routes: the decode route up to the crossover, the tiled one past
# it, each with and without split-K clusters.
Q4_ROWS = sorted({1, 3, 32, 33, 160, 1500, 6000, tq4.DECODE_MAX_ROWS,
                  tq4.DECODE_MAX_ROWS + 1})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,k", [(1280, 1280), (3840, 1280), (5120, 1280),
                                 (1280, 5120)])
@pytest.mark.parametrize("m", Q4_ROWS)
def test_int4_linear_kernel_matches_plain(cuda_device, m, n, k, dtype):
    """Q4 against its plain version (the weight dequantized in the compute
    type, ``F.linear``, the bias): relative L2 below 1e-2 in bf16 (one
    rounding of the output apart) and 1e-5 in f32 (summation order)."""
    x, w, s, b = _q4_operands(cuda_device, m, n, k, dtype, bias=m != 3)
    before = tq4.Q4_LAUNCHES
    got = tq4.int4_linear(x, w, s, b)
    torch.cuda.synchronize()
    assert tq4.Q4_LAUNCHES == before + 1
    ref = tq4.int4_linear_plain(x, w, s, b)
    assert got.shape == (m, n) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got, ref) < (1e-2 if dtype == torch.bfloat16 else 1e-5)


def test_int4_linear_kernel_plans_take_both_routes(cuda_device):
    """The matrix above reaches the decode route with and without split-K,
    and the tiled route with and without it, on this card."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plans = {(m, n, k): tq4.plan(m, n, k, sms) for m in Q4_ROWS
             for n, k in ((1280, 1280), (3840, 1280), (5120, 1280), (1280, 5120))}
    for route in ("decode", "tiled"):
        assert any(p.route == route and p.split > 1 for p in plans.values())
        assert any(p.route == route and p.split == 1 for p in plans.values())
    assert plans[(tq4.DECODE_MAX_ROWS, 1280, 1280)].route == "decode"
    assert plans[(tq4.DECODE_MAX_ROWS + 1, 1280, 1280)].route == "tiled"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 32, 1280])
@pytest.mark.parametrize("n,k", [(1280, 1280), (3840, 1280), (5120, 1280),
                                 (1280, 5120)])
def test_int4_linear_kernel_is_exact_on_identity_rows(cuda_device, n, k, m, dtype):
    """x rows e_k (no bias) give the plain version's dequantized weight
    columns bit for bit on every route (decode with and without split-K,
    tiled, f32): each weight is bf16(q) x bf16(s) rounded once, as JAX
    rounds it, whatever the order of the sum."""
    _, w, s, _ = _q4_operands(cuda_device, 1, n, k, dtype, bias=False)
    cols = torch.arange(m, device=cuda_device) * 7 % k
    x = torch.zeros(m, k, dtype=dtype, device=cuda_device)
    x[torch.arange(m, device=cuda_device), cols] = 1
    got = tq4.int4_linear(x, w, s)
    dense = tq4.unpack_int4(w).to(dtype) * s.to(dtype)[:, None]
    assert torch.equal(got, dense[:, cols].t())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_linear_kernel_is_deterministic_and_replays(cuda_device, dtype):
    """The same output bit for bit from call to call and from a CUDA-graph
    replay (the S4 decode step's route), at 3-D x: the decode route at
    M = 1 (N = 3840, and N = 1280 with split-K), the tiled route at M =
    1500 and 6000 (the cross K/V at B = 1 and 4)."""
    for n, shape in ((3840, (1, 1, 1280)), (1280, (1, 1, 1280)),
                     (3840, (2, 750, 1280)), (1280, (4, 1500, 1280))):
        x, w, s, b = _q4_operands(cuda_device, 1, n, 1280, dtype)
        x = torch.randn(shape, generator=torch.Generator().manual_seed(3)
                        ).to(dtype).to(cuda_device)
        first = tq4.int4_linear(x, w, s, b)
        assert first.shape == (*shape[:-1], n)
        assert torch.equal(tq4.int4_linear(x, w, s, b), first)
        out = torch.empty_like(first)
        graph = capture(lambda: out.copy_(tq4.int4_linear(x, w, s, b)))
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
        x.copy_(torch.randn(shape, generator=torch.Generator().manual_seed(4)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tq4.int4_linear(x, w, s, b))


def test_int4_linear_kernel_rejects_bad_input(cuda_device):
    before = tq4.Q4_LAUNCHES
    x, w, s, b = _q4_operands(cuda_device, 4, 256, 256, torch.bfloat16)
    wide = torch.randn(256, 4, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tq4.int4_linear(wide.t(), w, s, b)
    with pytest.raises(ValueError, match="device"):
        tq4.int4_linear(x, w.cpu(), s, b)
    with pytest.raises(ValueError, match="dtype"):
        tq4.int4_linear(x.half(), w, s, b)
    with pytest.raises(ValueError, match="bias"):
        tq4.int4_linear(x, w, s, b.float())
    with pytest.raises(ValueError, match="multiple"):
        tq4.int4_linear(x[:, :192].contiguous(), w[:, :96].contiguous(), s, b)
    buf = torch.zeros(4 * 256 + 8, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        tq4.int4_linear(buf[1:1025].view(4, 256), w, s, b)
    assert tq4.Q4_LAUNCHES == before


def test_int4_linear_module_runs_q4(cuda_device):
    """``Int4Linear`` on a CUDA tensor launches Q4, at 3-D x."""
    lin = torch.nn.Linear(1280, 5120, dtype=torch.bfloat16)
    mod = tq.Int4Linear.from_linear(lin).to(cuda_device)
    x = torch.randn(2, 5, 1280, dtype=torch.bfloat16, device=cuda_device)
    before = tq4.Q4_LAUNCHES
    y = mod(x)
    assert tq4.Q4_LAUNCHES == before + 1 and y.shape == (2, 5, 5120)
    ref = tq4.int4_linear_plain(x, mod.weight, mod.scale, mod.bias)
    assert _rel_l2(y, ref) < 1e-2
