#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``thewhisper_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It fails (non-zero exit, no result line) where ``torch.cuda.is_available()``
is false. Phases, each of which raises on failure:

1. Device: torch and CUDA versions, the card's name and power limit.
2. Build: ``csrc/*.cu`` compiled by nvcc for sm_90a (``ops/_build.py``).
3. K1, the log-mel kernel, against its plain PyTorch version.
4. K2, the encoder attention kernel, against its plain PyTorch version.
5. The main path at the full width of large-v3-turbo (32 encoder layers,
   4 decoder layers, d_model 1280, 20 heads, vocab 51866) with random bf16
   weights from a seeded generator: ``ASRPipeline`` on a 20 s WAV with word
   timestamps, on a 70 s WAV (three windows and the LCS merge) and
   ``transcribe_batch`` of four buffers. It checks that both kernels ran on
   that path, that logits are finite, that timestamps are ordered, that
   the encoder with the kernels agrees with the plain version, and that a
   small f32 model transcribes the same on the card as on the CPU.

Times come from CUDA events; every number printed is measured in the run.
The last lines are the kernels' JSON line, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

from thewhisper_tpu.config import ARCH_PRESETS, SAMPLE_RATE, GenerationOptions
from thewhisper_tpu_torch.audio.features import (
    hann_window,
    log_mel_spectrogram,
    log_mel_spectrogram_plain,
    mel_filter_bank,
)
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.models.whisper import (
    compute_cross_kv,
    decoder_prefill,
    decoder_step,
    encoder_forward,
    init_params,
    make_cache,
)
from thewhisper_tpu_torch.ops import _build, logmel
from thewhisper_tpu_torch.ops import attention as attn
from thewhisper_tpu_torch.pipeline import ASRPipeline

ROOT = Path(__file__).resolve().parent
GEN_KW = {"language": "en", "max_new_tokens": 64}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """Voiced-speech-like test signal: amplitude-modulated harmonics of a
    gliding pitch plus noise, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6)))
    x = 0.2 * envelope * voiced + 0.02 * rng.standard_normal(len(t))
    return np.clip(x, -1, 1).astype(np.float32)


def write_wav(path: Path, x: np.ndarray) -> None:
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(SAMPLE_RATE)
        wf.writeframes((x * 32767).astype("<i2").tobytes())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on an NVIDIA GPU")
    # Every f32 comparison here is against true f32 (JAX's HIGHEST).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}", flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.lib()
    secs = time.perf_counter() - t0
    print(f"[build] {_build.library_path().name} ready in {secs:.2f} s "
          f"(nvcc {_build.build_seconds or 0.0:.2f} s)", flush=True)
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"[build]   {line.strip()}")


def phase_logmel() -> dict:
    """K1 at B in {1, 4}, 10 s and 30 s, 128 and 80 mels, f32. Bound: the
    normalized features to atol 5e-4, the bound tests/test_logmel_pallas.py
    holds the TPU kernel to (HF parity is ~1e-4)."""
    dev = torch.device("cuda", 0)
    win = torch.from_numpy(hann_window()).to(dev)
    main_shape = None
    for n_mels in (128, 80):
        fb = torch.from_numpy(mel_filter_bank(num_mel_filters=n_mels)).to(dev)
        for b in (1, 4):
            for seconds in (10, 30):
                audio = torch.from_numpy(np.stack(
                    [synth_audio(seconds, seed=i) for i in range(b)])).to(dev)
                out = log_mel_spectrogram(audio, fb, win)
                ref = log_mel_spectrogram_plain(audio, fb, win)
                torch.cuda.synchronize()
                check(out.shape == (b, n_mels, seconds * 100), "K1 shape")
                err = (out - ref).abs().max().item()
                check(err <= 5e-4, f"K1 err {err} > 5e-4 at B={b} {seconds}s "
                      f"{n_mels} mels")
                ms = cuda_ms(lambda: logmel.log_mel(audio, fb, win))
                plain_ms = cuda_ms(lambda: logmel.log_mel_plain(audio, fb, win))
                print(f"[K1] B={b} {seconds:>2d} s {n_mels:>3d} mels: max abs "
                      f"err {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms",
                      flush=True)
                if (b, seconds, n_mels) == (4, 30, 128):   # main-path shape
                    main_shape = {"max_abs_err": err, "ms": ms,
                                  "plain_ms": plain_ms}
    return main_shape


def phase_attention() -> dict:
    """K2 at B = 4, H = 20, dh = 64, S in {1500, 500} and one case with
    valid_len < S, f32 and bf16. Bounds: f32 max abs err 1e-4 (the same
    f32 math, summed in another order); bf16 max abs err relative to the
    output's max 2e-2 (the kernel keeps the probabilities in f32 where the
    plain version rounds them to bf16 before the value product; bf16 has
    8 significant bits, 2**-8 ~ 4e-3 per rounding)."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    main_shape = None
    for dtype in (torch.float32, torch.bfloat16):
        for s, valid_len in ((1500, None), (500, None), (1500, 1111)):
            q, k, v = (torch.randn(4, s, 20, 64, generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            out = attn.encoder_attention(q, k, v, valid_len=valid_len)
            ref = attn.encoder_attention_plain(q, k, v, valid_len=valid_len)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if dtype == torch.float32:
                check(err <= 1e-4, f"K2 f32 err {err} at S={s}")
                shown = f"max abs err {err:.3e}"
            else:
                rel = err / ref.float().abs().max().item()
                check(rel <= 2e-2, f"K2 bf16 rel err {rel} at S={s}")
                shown = f"max abs err {err:.3e} (rel {rel:.3e})"
            ms = cuda_ms(lambda: attn.encoder_attention(q, k, v, valid_len))
            plain_ms = cuda_ms(
                lambda: attn.encoder_attention_plain(q, k, v, valid_len))
            print(f"[K2] {str(dtype)[6:]:>8} B=4 S={s} valid={valid_len}: "
                  f"{shown}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms",
                  flush=True)
            if dtype == torch.bfloat16 and (s, valid_len) == (1500, None):
                main_shape = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms}
    return main_shape


def timed(label: str, fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[main] {label}: wall {wall:.3f} s, max_memory_allocated "
          f"{peak:.3f} GiB", flush=True)
    return out


def check_word_chunks(out: dict, duration: float, ordered: bool) -> None:
    check(isinstance(out["text"], str) and out["text"].strip() != "",
          "empty transcript")
    chunks = out["chunks"]
    check(len(chunks) > 0, "no word chunks")
    starts = [c["timestamp"][0] for c in chunks]
    for c in chunks:
        s, e = c["timestamp"]
        check(s is not None and 0.0 <= s <= duration, f"word start {s}")
        check(e is None or s <= e <= duration + 1e-6, f"word span {s}..{e}")
    if ordered:
        check(all(a <= b for a, b in zip(starts, starts[1:])),
              "word starts out of order")


def phase_main_path() -> dict:
    dev = torch.device("cuda", 0)
    arch = dataclasses.replace(
        ARCH_PRESETS["large-v3-turbo"],
        # A few heads on the last two decoder layers, so DTW has input.
        alignment_heads=((2, 4), (2, 11), (3, 3), (3, 17)))
    t0 = time.perf_counter()
    model = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] large-v3-turbo, {n_params / 1e6:.1f} M bf16 parameters, "
          f"random init {time.perf_counter() - t0:.2f} s", flush=True)
    engine = WhisperEngine(model)
    pipe = ASRPipeline(engine, chunk_length_s=30)
    batch = [synth_audio(s, seed=10 + i) for i, s in enumerate((4, 9, 17, 30))]

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        wav20, wav70 = Path(tmp) / "speech20.wav", Path(tmp) / "speech70.wav"
        write_wav(wav20, synth_audio(20, seed=1))
        write_wav(wav70, synth_audio(70, seed=2))

        logmel.LOGMEL_LAUNCHES = 0
        attn.ATTN_LAUNCHES = 0
        r20 = timed("20 s WAV, word timestamps", lambda: pipe(
            str(wav20), return_timestamps="word", generate_kwargs=dict(GEN_KW)))
        r70 = timed("70 s WAV, 3 windows + LCS merge", lambda: pipe(
            str(wav70), return_timestamps="word", generate_kwargs=dict(GEN_KW)))
        rb = timed("transcribe_batch of 4 (4, 9, 17, 30 s)",
                   lambda: pipe.transcribe_batch(
                       batch, return_timestamps="word",
                       generate_kwargs=dict(GEN_KW)))
        launches = {"logmel": logmel.LOGMEL_LAUNCHES,
                    "encoder_attention": attn.ATTN_LAUNCHES}
    print(f"[main] kernel launches on the main path: {launches}", flush=True)
    # Three engine calls, each featurizes once (K1) and encodes one batch
    # (K2 in each of the 32 encoder layers).
    check(launches["logmel"] == 3, f"K1 launches {launches['logmel']} != 3")
    check(launches["encoder_attention"] == 3 * arch.encoder_layers,
          f"K2 launches {launches['encoder_attention']} != 3 x 32")

    check_word_chunks(r20, 20.0, ordered=True)
    # The merged 70 s transcript is not checked for order: with random
    # weights the windows share no tokens, so the LCS merge concatenates
    # them whole and window 1's tail (to 30 s) precedes window 2 (from 20 s).
    check_word_chunks(r70, 70.0, ordered=False)
    check(len(rb) == 4, "transcribe_batch rows")
    for r, a in zip(rb, batch):
        check_word_chunks(r, len(a) / SAMPLE_RATE, ordered=True)
    print(f"[main] 20 s: {len(r20['chunks'])} words, 70 s: "
          f"{len(r70['chunks'])} words, batch: "
          f"{[len(r['chunks']) for r in rb]} words", flush=True)

    with torch.inference_mode():
        # One 30 s window: the encoder through both kernels against the
        # same encoder through the plain attention, and finite logits.
        mel = pipe.featurizer(synth_audio(30, seed=3))
        enc = encoder_forward(model, mel)
        enc_plain = encoder_forward(model, mel,
                                    attention=attn.encoder_attention_plain)
        diff = (enc.float() - enc_plain.float())
        rel = (diff.norm() / enc_plain.float().norm()).item()
        print(f"[main] encoder, kernels vs plain attention, bf16 30 s: "
              f"relative L2 err {rel:.3e}, max abs err "
              f"{diff.abs().max().item():.3e}", flush=True)
        # 32 bf16 layers: each layer's output rounds to bf16 (2**-9
        # relative) and the kernel's f32 probabilities differ from the
        # plain version's bf16 ones; the difference compounds over depth.
        check(rel <= 5e-2, f"encoder kernel-vs-plain rel err {rel}")
        check(bool(torch.isfinite(enc).all()), "encoder output not finite")
        ck, cv = compute_cross_kv(model, enc)
        cache = make_cache(arch, 1, 8, ck, cv)
        prompt = torch.tensor([engine.build_prompt("en")], device=dev)
        logits, cache, _ = decoder_prefill(model, prompt, cache)
        step_logits, _, _ = decoder_step(model, logits[:, -1:].argmax(-1), 4,
                                         cache)
        check(logits.shape == (1, 4, arch.vocab_size)
              and logits.dtype == torch.float32, "prefill logits shape/type")
        check(bool(torch.isfinite(logits).all()
                   and torch.isfinite(step_logits).all()), "logits not finite")
    res = engine.transcribe_audio(
        synth_audio(30, seed=4)[None],
        GenerationOptions(**GEN_KW, return_timestamps=True))
    check(bool(np.isfinite(res.token_logprobs).all()
               and np.isfinite(res.sum_logprob).all()
               and np.isfinite(res.align).all()), "engine result not finite")
    return launches


def phase_small_reference() -> None:
    """A small f32 model (d_model 256, 4 heads of 64, 2 + 2 layers, the
    real vocab) transcribes a 20 s window identically on the card (K1, K2,
    cuBLAS and cuDNN without TF32) and on the CPU (plain versions)."""
    arch = dataclasses.replace(
        ARCH_PRESETS["large-v3-turbo"], d_model=256, encoder_layers=2,
        encoder_heads=4, decoder_layers=2, decoder_heads=4, d_ff=1024,
        alignment_heads=((1, 0), (1, 2)))
    cpu_model = init_params(arch, torch.Generator().manual_seed(1))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    audio = synth_audio(20, seed=5)
    outs = []
    for model in (cpu_model, gpu_model):
        pipe = ASRPipeline(WhisperEngine(model), chunk_length_s=30)
        outs.append(pipe(audio, return_timestamps="word",
                         generate_kwargs={"language": "en",
                                          "max_new_tokens": 32}))
    check(outs[0] == outs[1], "small f32 model: card and CPU transcripts differ")
    print(f"[ref] small f32 model, 20 s: card == CPU ({len(outs[1]['chunks'])} "
          "words, identical text and word timestamps)", flush=True)


def main() -> None:
    smi = phase_device()
    phase_build()
    k1 = phase_logmel()
    k2 = phase_attention()
    launches = phase_main_path()
    phase_small_reference()
    kernels = [
        {"name": "logmel", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/logmel.cu",
         "replaces": "thewhisper_tpu/ops/logmel_pallas.py:113",
         "launches": launches["logmel"], **k1},
        {"name": "encoder_attention", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "thewhisper_tpu/models/whisper.py:189",
         "launches": launches["encoder_attention"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
