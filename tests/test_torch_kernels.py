"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips elsewhere:
a CUDA kernel has no CPU mode. The module imports no JAX, so it also runs
where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Shapes are the slice's production shapes: 10 s and 30 s of audio (1000 and
3000 frames), S = 1500 and 500 encoder positions, 20 heads of 64; K3 (the
decode step) and K4 (the verify window) at a small arch, d_model 384 with
heads of 64 and 2 layers (chip_smoke.py holds them at large-v3 width). The
probe kernels (P1-P5) at small sizes: the no-exp attention control at
S = 1024 and 1536, the int8 MLP chain at d_model 256, d_ff 1024, the slot
writes at the probes' own cache shapes.
"""

import dataclasses

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
from thewhisper_tpu_torch.ops import mega_step as tm
from thewhisper_tpu_torch.ops import mlp_chain as tmc

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
    for name in ("twt_logmel", "twt_encoder_attention", "twt_mega_step",
                 "twt_mega_verify", "twt_attention_control", "twt_mlp_chain",
                 "twt_strided_write"):
        assert hasattr(lib, name)
    if _build.build_log is not None:
        print(_build.build_log)


@pytest.mark.parametrize("batch,seconds,n_mels", [
    (1, 30.0, 128), (4, 10.0, 80), (4, 30.0, 128), (2, 1.3, 128)])
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


def test_logmel_kernel_rejects_bad_input(cuda_device):
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=80)).to(cuda_device)
    win = torch.from_numpy(tf.hann_window()).to(cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        logmel.log_mel(torch.zeros(1, 1000, device=cuda_device), fb, win)
    with pytest.raises(ValueError, match="float32"):
        logmel.log_mel(torch.zeros(1, 1600, device=cuda_device,
                                   dtype=torch.float64), fb, win)


def _qkv(b, s, h, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, s, h, 64, generator=g).to(device, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,valid_len", [
    (4, 1500, None), (4, 500, None), (2, 1500, 1111), (1, 77, 5)])
def test_attention_kernel_matches_plain(cuda_device, dtype, b, s, valid_len):
    q, k, v = _qkv(b, s, 20, dtype, cuda_device)
    before = ta.ATTN_LAUNCHES
    out = ta.encoder_attention(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    assert ta.ATTN_LAUNCHES == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = ta.encoder_attention_plain(q, k, v, valid_len=valid_len)
    # f32: summation order only. bf16: the kernel keeps the probabilities in
    # f32 where the plain version rounds them to bf16 before the value
    # product; both round the output to bf16 once.
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_attention_kernel_takes_strided_views(cuda_device):
    """The encoder passes (B, S, H, dh) views of (B, S, d) projections."""
    x = torch.randn(2, 300, 3 * 20 * 64, device=cuda_device)
    q, k, v = (t.view(2, 300, 20, 64) for t in x.chunk(3, dim=-1))
    torch.testing.assert_close(ta.encoder_attention(q, k, v),
                               ta.encoder_attention_plain(q, k, v),
                               atol=1e-4, rtol=1e-4)


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


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s", [(1, 2, 1024), (2, 3, 1536)])
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


def test_attention_control_kernel_rejects_bad_input(cuda_device):
    x = torch.zeros(1, 2, 1000, 64, device=cuda_device)
    with pytest.raises(ValueError, match="512"):
        tac.attention_control(x, x, x)
    y = torch.zeros(1, 2, 512, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tac.attention_control(y, y, y)


def _mlp_case(device, n_layers=2, d=256, f=1024, seed=0):
    """The probe's operands, random LayerNorm parameters included (a kernel
    that misreads one would pass with unit scales and zero shifts)."""
    from thewhisper_tpu_torch.tools.gemv_chain_probe import make_inputs, operands

    g = torch.Generator(device="cpu").manual_seed(seed)
    p = make_inputs(n_layers, d, f, g, torch.device("cpu"))
    return p["x"].to(device), [t.to(device) for t in operands(p)]


@pytest.mark.parametrize("n_layers", [1, 3])
def test_mlp_chain_kernel_matches_plain(cuda_device, n_layers):
    """P2 against its plain version within 1e-2 of the largest value (the
    same bf16 rounding points, f32 sums in another order); P3 over every
    layer in turn equals P2 bit for bit (the same partials summed in the same
    order)."""
    x, ops = _mlp_case(cuda_device, n_layers)
    before = tmc.MLP_CHAIN_LAUNCHES, tmc.MLP_LAYER_LAUNCHES
    chain = tmc.mlp_chain(x, *ops)
    y = x
    for l in range(n_layers):
        y = tmc.mlp_layer(y, l, *ops)
    torch.cuda.synchronize()
    assert (tmc.MLP_CHAIN_LAUNCHES, tmc.MLP_LAYER_LAUNCHES) == (
        before[0] + 1, before[1] + n_layers)
    assert chain.shape == x.shape and chain.dtype == torch.bfloat16
    assert _rel(chain, tmc.mlp_chain_plain(x, *ops)) < 1e-2
    assert torch.equal(y, chain)
    assert torch.equal(tmc.mlp_chain(x, *ops), chain)       # deterministic


def test_mlp_chain_kernel_rejects_bad_input(cuda_device):
    x, ops = _mlp_case(cuda_device, 1, d=192, f=512)
    with pytest.raises(ValueError, match="multiples"):
        tmc.mlp_chain(x, *ops)
    x, ops = _mlp_case(cuda_device, 2)
    with pytest.raises(ValueError, match="outside"):
        tmc.mlp_layer(x, 2, *ops)


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
