#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``thewhisper_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It fails (non-zero exit, no result line) where ``torch.cuda.is_available()``
is false. Phases, each of which raises on failure:

1. Device: torch and CUDA versions, the card's name and power limit.
2. Build: ``csrc/*.cu`` compiled by nvcc for sm_90a (``ops/_build.py``).
3. K1, the log-mel kernel, against its plain PyTorch version, timed beside
   the ``torch.stft`` route (which it must beat at B = 4 x 30 s).
4. K2, the encoder attention kernel, against its plain PyTorch version at
   30 s (S = 1500) and 10 s (S = 500, B = 1, 3 and 4) windows; the
   bf16 route timed at B = 1, 4 and 32 beside
   ``scaled_dot_product_attention`` (at B = 4 it must beat the plain version
   and stay within 1.5x of the library call).
5. The main path at the full width of large-v3-turbo (32 encoder layers,
   4 decoder layers, d_model 1280, 20 heads, vocab 51866) with random bf16
   weights from a seeded generator: ``ASRPipeline`` on a 20 s WAV with word
   timestamps, on a 70 s WAV (three windows and the LCS merge) and
   ``transcribe_batch`` of four buffers. It checks that both kernels ran on
   that path, that logits are finite, that timestamps are ordered, that
   the encoder with the kernels agrees with the plain version, the bf16
   encoder's wall at B = 1, 3 and 4 with K2, the plain attention and the
   library attention (K2 must beat the plain attention at B = 4), and that a
   small f32 model transcribes the same on the card as on the CPU, and
   decodes the same tokens speculatively (ngram, a one-layer layer-skip
   draft) as greedily, on the card and on the CPU, and the same tokens
   with three beams on both. It prints the bf16
   encoder's relative L2 drift from an f32 copy with the plain attention.
   [ASR] The offline CLI (``python -m thewhisper_tpu_torch.run_asr``) on
   that model written as a checkpoint in two shards and an index:
   ``--model-size XL`` on the 70 s WAV with ``--srt``, its text and word
   chunks equal, bit for bit, to ``ASRPipeline`` over the in-memory model;
   ``--model-size S`` on the 20 s WAV at batch 1, K3 once a step call; K1
   and K2 counted, the SRT cues parsed, DTW in the C++ host runtime
   (``native_lib``) and timed against its numpy version on the calls' own
   matrices and on 100 of a 9 s window's shape (equal paths); a FLAC
   through ``load_audio`` where ``ffmpeg`` is installed.
   [GRAPH] The bf16 turbo greedy loop replayed from CUDA graphs against
   the same loop eager (``WhisperEngine(cuda_graphs=False)``), 30 s
   windows, 64 new tokens, at batch 1 and at batch 3 (bucket 4): every
   output field equal, bit for bit; ms a step of each route (the decode
   alone, host clock, p50 of 5), the graph's device ms a step, each key's
   capture time and device memory. Then sampled calls at each batch, two
   seeds at temperature 0.7 and one at 0.3, on one graph: each call's
   result from the graph equals the eager one, bit for bit, and the
   seeds' tokens differ.
   [BEAM] The same at batch 2 x 4 beams with word timestamps; the best
   beam's sum_logprob equals the sum of its token_logprobs.
   [LONGFORM] The bench's long-form protocol through the port's pipeline
   (``phase_longform``): a 600 s synthetic file, 10 s pipelines, 9 s call
   windows on a 9 s latency bucket, 32 new tokens, EOT suppressed. bf16
   turbo at batch 32 (depth 2, the offset path), then two batch-32 calls
   with word timestamps (the second timed beside the numpy DTW on the
   same matrices; the host seconds in the native DTW printed); after
   [turbo S], turbo "S" at batch 1 (depth 0;
   depth 2 in groups of 4 windows) and at batch 32 (depth 2, groups of 3
   batches, the first-window fast path). Each arm warm once, then timed
   in turns: wall, RTFx, first result, and the K1, K2 and K3 launches,
   which must be one K1 an engine call, one K2 an encoder layer of each
   and a K3 every step call at batch 1. The batch-1 texts must be equal;
   window 0 of the fast path must equal a batch-1
   ``transcribe_window_async`` of it, bit for bit; K1 at 9 s and K2 at
   S = 450 on the path's inputs against their plain versions.
   [turbo S] Then the same model quantized as ``"int8-all"`` with int8
   cross K/V (the engine warmed first): the 20 s WAV at batch 1, every
   step call of the loop one K3 launch, replayed from its graph; then
   [GRAPH] on that K3 route at batch 1, greedy and sampled (K3 once a
   step call).
   [STREAM] That engine under the streaming pipeline (featurizers built
   under ``torch.inference_mode``; 10 s windows, the
   neural VAD, cross-tick reuse on and off, and on for an engine without
   graphs): 30 s of speech and near-silence in 0.05 s chunks; every tick
   one K1 and a K2 a layer, the greedy ticks K3, the drafted ticks from
   the proposals programs the warm-up made (no tick makes a program), the
   buffer within the window; tick walls, the native DTW's ms a tick
   beside the numpy sweep's on the same matrices, and the drafted ticks'
   count. A
   fourth arm decodes three tokens a tick and must commit words, ordered
   and none after the stream's clock.
   [SERVER] The same engine behind the REST server the entry point
   builds: three sessions at once over stdlib HTTP (every response 200, a
   coalesced batch above 1, K1 and K2 launched; the walls of the
   ``process`` calls that transcribed apart from those that did not),
   then one session alone, equal to the streaming pipeline fed directly.
   [PAD] What a padded row costs: that engine's proposals call at batch
   3, padded to bucket 4 with a zero row as the server pads three drafted
   ticks, against the same call on an engine with a bucket of 3, and the
   zero row alone: rounds and walls, the drafted tokens greedy's.
6. [S] The "S" main path at the full width of large-v3 (32 + 32 layers,
   d_model 1280, 20 heads, d_ff 5120, vocab 51866): random bf16 weights,
   biases and LayerNorm parameters,
   quantized as ``"int8-all"`` (int8 decoder and table, W8A8 encoder),
   ``WhisperEngine(cross_kv_int8=True)`` (K3 packed), ``ASRPipeline`` on a
   20 s WAV with word timestamps (batch 1: every decode step is one K3
   launch) and ``transcribe_batch`` of four buffers (batch 4: the plain
   int8 step, no K3 launch). Prints the W8A8 encoder's error against the
   bf16 encoder, walls, peak memory and the model's bytes.
7. [K3] The decode step kernel against its plain version at large-v3 width
   on the production cross K/V (the W8A8 encoder with K2, T = 1500): at
   L = 32 for cache lengths 5, 68 and 228, at L = 4 (turbo's depth) and at
   L = 1 over eight steps, the best of which must agree to f32 noise; at
   L = 4 and 32 over a 10 s window's cross K/V (T = 500, a streaming
   tick's); at
   every depth the kernel's distance from the same function computed in f32
   at most 1.5 times the bf16 plain version's. Times of both at each, the
   kernel eager and from a CUDA graph, and the phase stamps of one L = 32
   step (where the launch's time goes). The kernels line's K3 times are the
   decode loop's route: the slot read from device memory, the
   self-attention planned for the whole cache (equal to the host int's
   launch, bit for bit); that route is also timed at L = 32 on a 448-slot
   cache at positions 10 and 400 beside the host int's.
8. [K4] The verify-window kernel against its plain version on the S model's
   operands: L = 32 with windows of 5 (cache 73), 16 (cache 84) and 1, L = 4
   and L = 1 over eight windows, K3's checks; one L = 1 window against K3
   stepping the same tokens; times of K4 (eager and from a CUDA graph) and
   the plain verify a round at L = 32 for windows 1, 5 and 16 beside K3's
   time a step, and the phase stamps of one window of 5.
9. [SPEC] The speculative "S" path at large-v3 width: engines on the S
   model with ngram drafting (``spec_ngram=True``) and with a two-layer
   layer-skip draft, each with CUDA graphs (warmed) and without,
   ``ASRPipeline`` on the 20 s WAV without timestamps (batch 1: every
   verify round is one K4 launch, replayed from the graph or eager, and
   no K3), and the K3 greedy call on the same WAV: each draft's graph and
   eager results equal bit for bit; walls a call, rounds, tokens a round,
   the shared token prefix and each speculative program's capture
   seconds and bytes.
9b. [S4] The int4 "S4" path at large-v3 width on [S]'s bf16 weights (the
    same seed), the decoder quantized with ``quantize_params(bits=4)``
    (int4 linears, int8 table), the encoder bf16 with K2,
    ``WhisperEngine(cross_kv_int8=True)``: ``model.mega`` None, so no K3
    or K4 launch; ``ASRPipeline`` on the 20 s WAV at batch 1 with word
    timestamps and ``transcribe_batch`` of four buffers, the engine warmed
    first; Q4 launches 6 x 32 a step, replayed from the graph, 6 x 32 for
    the prefill and 2 x 32 for the cross K/V of each call; graph against
    eager at batch 1 and 4 (every output field equal, bit for bit); ms a
    step from the graph at batch 1 and 4 beside S's plain int8 step
    (``megakernel=False``) and S's K3 route at batch 1; quantized bytes
    and peak memory; a small f32 S4 model with the same tokens on the
    card (Q4) as on the CPU (plain), greedy and layer-skip.
    [Q4] The kernel alone at large-v3's six decoder linears, 32 layers in
    one CUDA graph, at M = 1, 4, 32, 160 and 1500 rows (its decode route
    up to the crossover, its tiled route above), and at the cross K/V's
    own shape at a batch of four windows (M = 6000, 1280 x 1280), with
    PDL on and off, beside its plain version, ``F.linear`` on dense bf16
    weights (the yardstick), the library's int4 product
    ``torch._weight_int4pack_mm`` on the same weights and its bound, the
    routes and splits its plan chose; Q4 and the library call held to the
    plain version on layer 0 (relative L2 < 1e-2).
9c. [PROFILE] ``utils/flops.py`` and ``utils/profiling.py`` on the card, on
    models the run built: (a) after the bf16 [LONGFORM], bf16 turbo's
    encoder MFU at B = 32 x 30 s and its decode step's MFU and HBM share
    at B = 32 from a CUDA-graph replay, with FLOPs and bytes, each in
    (0, 1]; (c) after the turbo "S" [LONGFORM], ``trace()`` around a
    call of its batch-1 depth-2 arm on the 600 s file's first 120 s, its
    stages in ``annotate`` spans: the device's idle share (over the traced
    span and against the same call's untraced wall) and its three longest
    idle gaps with the span and host op running at their start; (b)
    after [Q4], ``trace()`` around replays of the S4 step's batch-1
    graph: its device span, kernels and Q4's launches a step (6 a layer),
    Q4's share, the eight largest kernels and the idle time inside the
    step. A trace without a CUDA kernel event fails the run; the traces
    are written under a temporary directory and deleted.
10. [P1] The no-exp attention control (the TPU attention probe's timing
    control) against its plain version at B = 4 and at the probe's B = 32,
    H = 20, S = 1536, bf16, and in f32 at B = 1, S = 1024; the B = 32 bf16
    call timed eagerly and from a CUDA graph (at most 3.2 ms), beside K2 and
    ``scaled_dot_product_attention`` on the same inputs, yardsticks of
    softmax attention (no PyTorch call computes P1's function).
11. [P2]/[P3] The int8 MLP chain at d_model 1280, d_ff 5120, its weights
    packed once, against its plain version at L = 32 and L = 1; 32
    one-layer launches equal one chain bit for bit; device times (P2 at
    L = 32 at most 0.55 ms, P3 over 32 distinct layers at most 0.70 ms,
    P3 on one layer replayed from L2 beside them), GB/s, the pack's time
    and the phase stamps of one P2 launch.
12. [P4]/[P5] The row and column cache writes, bit-exact with host and
    device slots, every other slot unchanged; 16 writes of each replayed
    from a CUDA graph at slots refilled on the card; the P5 -> P4 -> P4
    relay of programmatic launches, eager and from a graph. Times from
    CUDA graphs in turns: the launch floor (an empty kernel, with and
    without PDL), each kernel beside the torch in-place write and
    ``index_copy_`` (P4 at most 1.1x the torch write, P5 L2-resident at
    most 1.1x both), P5 L2-resident and HBM-cold beside its sector floor.
    P2-P5's times are device times from CUDA-graph replays: a wrapper's
    host work (10-80 us a call) is more than these kernels take on the
    card.
13. [probes] The probes' path: each probe entry point
    (``thewhisper_tpu_torch.tools``) runs on the card, with the launch counts
    of its kernels read around it.
14. [TRAIN] The training path: K2 with its residual (lse), K2-dkv and
    K2-dq (the TPU library flash attention's save_residuals forward and its
    two backward kernels) against their plain versions at B = 8 x S = 500,
    B = 4 x S = 1500 and B = 1 x S = 1500 with valid_len 1100, f32 and
    bf16, timed beside ``scaled_dot_product_attention``'s forward and
    backward (bf16 K2-dkv + K2-dq at B = 8 x S = 500 at most 1.5x its bf16
    backward; f32 K2-fwd-res, K2-dkv and K2-dq, all 3xTF32 on the tensor
    cores, K2-fwd-res at most its f32 forward and K2-dkv + K2-dq at most its
    whole f32 backward); then fine-tuning and
    distillation at large-v3-turbo's full
    width (``phase_train``: arms A, B and C, the checkpoint round trip
    through the stdlib safetensors writer and reader, a distilled
    layer-skip student), every training step's launches counted.
15. [MESH] The ``(dp, tp)`` mesh for serving (``phase_mesh``, after the
    others, their models freed): K2 against its plain version at the
    local head counts of tp 2 and 4 (10 and 5 heads) on the views a
    sharded layer gives it; then ranks in child processes started by
    ``parallel.launch.spawn`` that load the kernels the parent built:
    (a) one NCCL rank (dp 1 x tp 1), bf16 large-v3-turbo at full width,
    a 30 s input with alignment capture, the meshed engine replaying CUDA
    graphs with its NCCL all-reduces captured: tokens bit-identical to
    the unsharded engine's; (b) two gloo ranks on the one card (gloo's
    f32 and bf16 all-reduce and broadcast of CUDA tensors checked
    first), f32 with TF32 off at dp 1 x tp 2 and dp 2 x tp 1, tokens and
    ``num_generated`` equal to the unsharded engine's, then bf16 at
    tp 2, its prefill logits' relative L2 distance from the f32 model's
    at most 1.5x the unsharded bf16 model's, its agreeing token prefix
    printed; (c) the dp-2 coalescer, three requests with a language each,
    its text equal to the unsharded pipeline's. Every rank prints its K1
    and K2 launches (which must be above 0) and its local head count; the
    walls carry the card's name and power limit, (b)'s labelled as
    host-staged gloo on one card, which measures no deployment.
16. [MESH_TRAIN] The ``(dp, tp)`` mesh for training and the
    sequence-parallel encoder (``phase_mesh_train``, after [MESH]): K2
    with S_q != S_k (750, 375 and 188 queries over 1500 keys, 13 over 52
    with valid_len 50; f32 and bf16) against its plain version, timed
    beside the square K2; then large-v3-turbo at full width, the encoder
    cut to 4 layers, random f32 weights and biases, 10 s through K1, 64
    tokens, masks that zero a 4-token prompt and pad every row to its own
    length, the unsharded references computed in the parent: (a) one
    NCCL rank (dp 1 x tp 1), two f32 AdamW steps at batch 2 (the second
    with remat), loss, every gradient leaf and every updated parameter
    bit-identical to ``make_train_step`` on the unsharded model; (b) two
    gloo ranks on the one card, one f32 step at dp 1 x tp 2 and at
    dp 2 x tp 1 on a global batch of 4, a remat step at tp 2 (the loss
    within 1e-5 of the unsharded step's, every gathered gradient leaf
    within 1e-4 relative L2; replicated leaves bit-identical across tp
    ranks, every leaf across dp ranks; K2-fwd-res, K2-dkv and K2-dq
    launched on every rank at 10 local heads, no output gradient copied),
    then a bf16-compute step at tp 2 over f32 master weights (its
    gradients' distance from f32 at most 1.5x the unsharded bf16 step's);
    (c) the sequence-parallel encoder at tp 2 on whole 32-layer weights,
    30 s (750 queries a rank over 1500 keys), f32 within 1e-4 relative L2
    of the unsharded encoder, bf16 within 1.5x the unsharded bf16
    encoder's distance from f32. Walls and peak memory (reset between
    arms) beside the card's name and power limit, the gloo ones labelled
    host-staged on one card.

Times come from CUDA events; every time printed is measured in the run,
and the bounds are computed from the run's shapes. The kernels' JSON line
gives each kernel's launches on its path, its error against the plain
version, its time, the plain version's, the bound (the
larger of bytes over 3.35 TB/s and operations over the peak rate for their
type) and, where one PyTorch call computes the same function, that call's
time (and, for K2, ``sq_ne_sk``, [MESH_TRAIN]'s S_q != S_k cases with
their times, the square K2's and their bounds; for K3 and K4,
``graph_ms``, the device time from a CUDA graph; for P2 the pack's time and its phase stamps, for P3 the
L2-resident time of one layer replayed; for P4 and P5 the measured
launch floors; for P5 ``l2_resident_ms``, its ``ms``, ``cold_ms``, the
HBM-cold time, and ``sector_floor_ms``, a second bound computed as
``bound_ms`` is, from the 32-byte sector each 2-byte store dirties). The
last lines are the kernels' JSON line, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}`` (``count`` is 1: the
run uses one card, whatever the machine shows).
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import http.client
import io
import json
import math
import shutil
import subprocess
import tempfile
import threading
import time
import wave
from pathlib import Path
from urllib.parse import quote

import numpy as np
import torch

from thewhisper_tpu_torch import align, native_lib, run_asr
from thewhisper_tpu_torch.audio.features import (
    LogMelFeaturizer,
    hann_window,
    log_mel_spectrogram,
    log_mel_spectrogram_plain,
    mel_filter_bank,
)
from thewhisper_tpu_torch.audio.io import load_audio
from thewhisper_tpu_torch.config import (
    ARCH_PRESETS,
    LANGUAGES,
    SAMPLE_RATE,
    GenerationOptions,
    ServerConfig,
    SpecialTokens,
)
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.engine.decode import STEPS_PER_CHECK
from thewhisper_tpu_torch.engine.engine import PendingResult, to_device
from thewhisper_tpu_torch.engine.speculative import make_layer_skip_draft
from thewhisper_tpu_torch.models.checkpoint import (
    save_hf_checkpoint,
    shard_safetensors,
)
from thewhisper_tpu_torch.models.load import load_checkpoint
from thewhisper_tpu_torch.models.quant import (
    Int4Linear,
    QuantizedKV,
    quantize_kv,
    quantize_params,
    quantized_bytes,
)
from thewhisper_tpu_torch.models.whisper import (
    DecodeCache,
    compute_cross_kv,
    decoder_prefill,
    decoder_step,
    embed_tokens,
    encoder_forward,
    init_params,
    make_cache,
)
from thewhisper_tpu_torch.ops import _build, logmel
from thewhisper_tpu_torch.ops import attention as attn
from thewhisper_tpu_torch.ops import attention_control as control
from thewhisper_tpu_torch.ops import cache_write as cw
from thewhisper_tpu_torch.ops import int4_linear as q4
from thewhisper_tpu_torch.ops import mega_step as mega
from thewhisper_tpu_torch.ops import mlp_chain as mlp
from thewhisper_tpu_torch.pipeline import ASRPipeline
from thewhisper_tpu_torch.server.launch import serve_pipeline
from thewhisper_tpu_torch.streaming import LocalWhisperBackend, StreamingPipeline
from thewhisper_tpu_torch.streaming.batching import BatchedTranscriber
from thewhisper_tpu_torch.streaming.pipeline import (
    GIBBERISH_THRESHOLD,
    compression_ratio,
)
from thewhisper_tpu_torch.streaming.ring import RingBuffer as PlainRingBuffer
from thewhisper_tpu_torch.training import distill, train
from thewhisper_tpu_torch.tools import (
    attention_probe,
    cache_write_probe,
    gemv_chain_probe,
    mega_caps_probe,
    q4_probe,
)
from thewhisper_tpu_torch.tools._card import capture, card, cuda_ms, graph_ms
from thewhisper_tpu_torch.utils import profiling
from thewhisper_tpu_torch.utils.flops import (
    BF16_FLOPS,
    F32_FLOPS,
    HBM_BYTES_PER_S,
    TF32_FLOPS,
    decode_step_bytes,
    decode_step_flops,
    encoder_flops,
)

ROOT = Path(__file__).resolve().parent
GEN_KW = {"language": "en", "max_new_tokens": 64}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def bound(bytes_moved: float, flops: float, flops_per_s: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the memory
    rate and its operations over the peak rate for their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    smi = card(torch.device("cuda", 0))
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
                stft_ms = cuda_ms(lambda: stft_log_mel(audio, fb, win))
                print(f"[K1] B={b} {seconds:>2d} s {n_mels:>3d} mels: max abs "
                      f"err {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                      f"  torch.stft route {stft_ms:.4f} ms", flush=True)
                if seconds == 30 and n_mels == 128:
                    # Device time alone: the eager times above include the
                    # host's launch work, several launches for the stft route.
                    print(f"[K1] B={b} 30 s 128 mels, device time (CUDA graph): "
                          f"kernel {graph_ms(lambda: logmel.log_mel(audio, fb, win)):.4f}"
                          f" ms  torch.stft route "
                          f"{graph_ms(lambda: stft_log_mel(audio, fb, win)):.4f} ms",
                          flush=True)
                if (b, seconds, n_mels) == (4, 30, 128):   # main-path shape
                    # The least work for the function, in f32: the window,
                    # an FFT of the 400-sample frame (5 N log2 N), power,
                    # mel projection and log. K1's folded 3xTF32 DFT does
                    # about eight times as many operations.
                    frames = out.shape[0] * out.shape[2]
                    flops = frames * (400 + 5 * 400 * math.log2(400) + 3 * 201
                                      + 2 * 201 * n_mels + n_mels)
                    check(ms < stft_ms, f"K1 {ms} ms not faster than the "
                          f"torch.stft route {stft_ms} ms")
                    library_ms = stft_ms
                    main_shape = {"max_abs_err": err, "ms": ms,
                                  "plain_ms": plain_ms,
                                  **bound(nbytes(audio, fb, win, out), flops,
                                          F32_FLOPS),
                                  "library_ms": library_ms}
    return main_shape


def stft_log_mel(audio, fb, win):
    """K1's function by the library route, timed as a yardstick only:
    ``torch.stft``, the mel product and the log."""
    spec = torch.stft(audio, 400, 160, window=win, center=True,
                      pad_mode="reflect", return_complex=True)[..., :-1]
    mel = torch.matmul(fb.t(), spec.abs() ** 2)
    return torch.log10(torch.clamp_min(mel, 1e-10))


def sdpa_attention(q, k, v):
    """K2's function over every key by the library call, (B, S, H, dh) in
    and out: a yardstick only, never the port's path."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)


def phase_attention() -> dict:
    """K2 at B = 4, H = 20, dh = 64, S in {1500, 500} and one case with
    valid_len < S, f32 and bf16; bf16 at B = 1 and 32, and at S = 500 (a
    10 s window) at B = 1 and 3, the batches of a lone stream and of three
    coalesced server sessions. The f32 lines (3xTF32 on the tensor cores)
    also print the kernel's TFLOP/s and ``scaled_dot_product_attention``'s
    f32 time on the same inputs. Bounds: f32 max
    abs err 1e-4 (the same f32 math, summed in another order); bf16 max abs
    err relative to the output's max 2e-2 (both versions round the
    probabilities to bf16 before the value product, the kernel unnormalized
    against a running max, the plain version normalized; bf16 has 8
    significant bits, 2**-8 ~ 4e-3 per rounding). The bf16 kernel must beat
    the plain version and stay within 1.5x of
    ``scaled_dot_product_attention`` at B = 4."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    main_shape = None
    cases = [(dtype, 4, s, valid_len) for dtype in (torch.float32, torch.bfloat16)
             for s, valid_len in ((1500, None), (500, None), (1500, 1111))]
    cases += [(torch.bfloat16, b, s, None)
              for b, s in ((1, 1500), (32, 1500), (1, 500), (3, 500))]
    for dtype, b, s, valid_len in cases:
        q, k, v = (torch.randn(b, s, 20, 64, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        out = attn.encoder_attention(q, k, v, valid_len=valid_len)
        ref = attn.encoder_attention_plain(q, k, v, valid_len=valid_len)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        del ref
        if dtype == torch.float32:
            check(err <= 1e-4, f"K2 f32 err {err} at S={s}")
            shown = f"max abs err {err:.3e}"
        else:
            rel = err / out.float().abs().max().item()
            check(rel <= 2e-2, f"K2 bf16 rel err {rel} at B={b} S={s}")
            shown = f"max abs err {err:.3e} (rel {rel:.3e})"
        ms = cuda_ms(lambda: attn.encoder_attention(q, k, v, valid_len))
        plain_ms = cuda_ms(
            lambda: attn.encoder_attention_plain(q, k, v, valid_len),
            iters=20 if b <= 4 else 3)
        line = (f"[K2] {str(dtype)[6:]:>8} B={b} S={s} valid={valid_len}: "
                f"{shown}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if dtype == torch.float32:
            # The 3xTF32 route's rate (the f32 function's operations), beside
            # the library call on the same inputs where it computes the same
            # function (every key valid).
            flops = 4 * b * 20 * s * (valid_len or s) * 64
            line += f"; kernel {flops / ms / 1e9:.1f} TFLOP/s"
            if valid_len is None:
                line += (f", scaled_dot_product_attention "
                         f"{cuda_ms(lambda: sdpa_attention(q, k, v)):.4f} ms")
        if dtype == torch.bfloat16 and valid_len is None and s == 1500:
            library_ms = cuda_ms(lambda: sdpa_attention(q, k, v))
            flops = 4 * b * 20 * s * s * 64
            line += (f"  scaled_dot_product_attention {library_ms:.4f} ms; "
                     f"kernel {flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{flops / ms * 1e3 / BF16_FLOPS:.1%} of the bf16 peak")
            if b == 4:
                check(ms < plain_ms and ms <= 1.5 * library_ms,
                      f"K2 bf16 {ms} ms against plain {plain_ms} ms and "
                      f"scaled_dot_product_attention {library_ms} ms")
                main_shape = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms,
                              **bound(nbytes(q, k, v, out), flops, BF16_FLOPS),
                              "library_ms": library_ms}
        print(line, flush=True)
    return main_shape


def encoder_walls(model, featurizer) -> None:
    """The bf16 encoder's wall on B 30 s windows, B in {1, 3, 4}, with K2,
    with the plain attention and with ``sdpa_attention`` (a yardstick):
    host clock around ``torch.cuda.synchronize``, median of 5 after a
    warm-up call. K2 must beat the plain attention at B = 4."""
    fns = {"K2": attn.encoder_attention, "plain": attn.encoder_attention_plain,
           "sdpa": sdpa_attention}
    with torch.inference_mode():
        for b in (1, 3, 4):
            mel = featurizer([synth_audio(30, seed=40 + i) for i in range(b)])
            walls = {}
            for name, fn in fns.items():
                encoder_forward(model, mel, attention=fn)
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    encoder_forward(model, mel, attention=fn)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                walls[name] = sorted(times)[2]
            print(f"[main] encoder B={b} x 30 s, bf16, median of 5: K2 "
                  f"{walls['K2']:.2f} ms  plain attention {walls['plain']:.2f} ms"
                  f"  scaled_dot_product_attention {walls['sdpa']:.2f} ms",
                  flush=True)
            if b == 4:
                check(walls["K2"] < walls["plain"],
                      f"encoder with K2 {walls['K2']} ms not below the plain "
                      f"attention's {walls['plain']} ms")


def timed(label: str, fn, tag: str = "main"):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{tag}] {label}: wall {wall:.3f} s, max_memory_allocated "
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
    # Four engine calls, each featurizes once (K1) and encodes one batch
    # (K2 in each of the 32 encoder layers): the 20 s WAV, the 70 s WAV's
    # three windows on the offset path (split 2 + 1 to the batch buckets,
    # as JAX's _tail_fit splits a short tail), the batch of four.
    check(launches["logmel"] == 4, f"K1 launches {launches['logmel']} != 4")
    check(launches["encoder_attention"] == 4 * arch.encoder_layers,
          f"K2 launches {launches['encoder_attention']} != 4 x 32")

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
        # relative) and the kernel rounds its probabilities before the
        # division where the plain version rounds them after; the
        # difference compounds over depth.
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
    encoder_walls(model, pipe.featurizer)
    encoder_drift(model, pipe.featurizer)
    return launches, model


def encoder_drift(model, featurizer) -> None:
    """Prints the bf16 turbo encoder's (with K2) relative L2 drift from an
    f32 copy of it with the plain attention, on one 30 s window."""
    with torch.inference_mode():
        mel = featurizer(synth_audio(30, seed=3))
        enc = encoder_forward(model, mel)
        ref_model = copy.deepcopy(model).float()
        ref = encoder_forward(ref_model, mel.float(),
                              attention=attn.encoder_attention_plain)
        del ref_model
        rel = l2_rel(enc, ref).item()
    check(math.isfinite(rel), "encoder drift not finite")
    print(f"[main] bf16 encoder with K2 against an f32 encoder with the plain "
          f"attention, 30 s window: relative L2 {rel:.3e}", flush=True)


class DtwRecorder:
    """In its ``with`` block, records each cost matrix that
    ``align.dtw_path`` hands the host runtime (``costs``, by reference:
    ``align`` builds a new matrix a call and never writes it again) and
    the host seconds the native DTW takes (``seconds``). Inside a timed
    wall it adds two clock reads and a list append a call."""

    def __enter__(self):
        self.costs, self.seconds = [], 0.0
        self._native = native = align.dtw_path_native

        def recording(cost):
            t0 = time.perf_counter()
            try:
                return native(cost)
            finally:
                self.seconds += time.perf_counter() - t0
                self.costs.append(cost)

        align.dtw_path_native = recording
        return self

    def __exit__(self, *exc):
        align.dtw_path_native = self._native


class RingRecorder:
    """Stands in for a streaming pipeline's rolling buffer: forwards each
    call to the buffer it wraps and logs it (the written chunks by
    reference: the pipeline never writes them again), so that
    :func:`ring_against_plain` can replay the session on both rings. Inside
    a timed wall it adds one method call and a list append an operation."""

    def __init__(self, buffer):
        self.buffer, self.ops = buffer, []

    def __len__(self) -> int:
        self.ops.append(("len", ()))
        return len(self.buffer)

    def write(self, samples) -> None:
        self.ops.append(("write", (samples,)))
        self.buffer.write(samples)

    def peek(self, *args):
        self.ops.append(("peek", args))
        return self.buffer.peek(*args)

    def discard(self, n) -> None:
        self.ops.append(("discard", (n,)))
        self.buffer.discard(n)

    def clear(self) -> None:
        self.ops.append(("clear", ()))
        self.buffer.clear()


def ring_against_plain(ops) -> tuple:
    """A logged session's buffer operations replayed on a fresh
    ``native_lib.RingBuffer`` and a fresh ``streaming/ring.py`` buffer in
    step: every ``len`` and ``peek`` must agree. Then each ring alone, timed
    (median of 3 replays). Returns each one's ms over all the operations."""

    def replay(ring, op, args):
        return len(ring) if op == "len" else getattr(ring, op)(*args)

    native, plain = native_lib.RingBuffer(), PlainRingBuffer()
    for i, (op, args) in enumerate(ops):
        a, b = replay(native, op, args), replay(plain, op, args)
        same = np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
        check(same, f"the native ring and the numpy ring differ at operation "
                    f"{i} ({op})")
    ms = []
    for make in (native_lib.RingBuffer, PlainRingBuffer):
        times = []
        for _ in range(3):
            ring = make()
            t0 = time.perf_counter()
            for op, args in ops:
                replay(ring, op, args)
            times.append(time.perf_counter() - t0)
        ms.append(float(np.median(times)) * 1e3)
    return tuple(ms)


def dtw_against_plain(costs) -> tuple:
    """The native DTW and its plain numpy version on each matrix: the
    paths must be equal. Returns each one's ms over all of them."""
    native = plain = 0.0
    for cost in costs:
        t0 = time.perf_counter()
        got = native_lib.dtw_path_native(cost)
        t1 = time.perf_counter()
        want = align.dtw_path_plain(cost)
        t2 = time.perf_counter()
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"native DTW path differs from the plain version at {cost.shape}")
        native += t1 - t0
        plain += t2 - t1
    return native * 1e3, plain * 1e3


ASR_TOKENS = 64
# A 9 s window's alignment: 32 new tokens and the prompt's rows by 450
# encoder frames.
DTW_WINDOW = (40, 450)


def parse_srt(text: str) -> list:
    """(number, start s, end s, text) of each cue of an SRT file."""
    def seconds(stamp):
        h, m, rest = stamp.split(":")
        s, ms = rest.split(",")
        return int(h) * 3600 + int(m) * 60 + int(s) + int(ms) / 1000

    cues = []
    for block in text.strip().split("\n\n"):
        number, span, *words = block.split("\n")
        start, end = span.split(" --> ")
        cues.append((int(number), seconds(start), seconds(end), " ".join(words)))
    return cues


def check_srt(path: Path, duration: float, ordered: bool) -> int:
    """The cues parse and are numbered 1..n, each with text and start <=
    end, starting within the audio and ending within it or, for an open
    last word, 0.5 s past its start (``utils/subtitles.py``'s rule); with
    ``ordered``, cue starts never go back. Returns the number of cues."""
    cues = parse_srt(path.read_text(encoding="utf-8"))
    check(len(cues) > 0 and [c[0] for c in cues] == list(range(1, len(cues) + 1)),
          f"[ASR] {path.name}: cue numbers")
    for _, start, end, text in cues:
        check(text.strip() != "" and 0.0 <= start <= min(end, duration)
              and end <= duration + 0.5, f"[ASR] {path.name}: cue {start}..{end}")
    if ordered:
        check(all(a[1] <= b[1] for a, b in zip(cues, cues[1:])),
              f"[ASR] {path.name}: cues out of order")
    return len(cues)


def run_cli(argv: list, results: list) -> dict:
    """``run_asr.main(argv)`` with the kernels' and the DTW's counts zeroed
    just before: its result, what it printed, the wall (checkpoint load
    included), K1/K2/K3 launches, native DTW calls and the recorder, and
    the (engine, result) of each engine call it made."""
    results.clear()
    printed = io.StringIO()
    torch.cuda.synchronize()
    logmel.LOGMEL_LAUNCHES = attn.ATTN_LAUNCHES = mega.MEGA_LAUNCHES = 0
    native_lib.DTW_CALLS = 0
    t0 = time.perf_counter()
    with DtwRecorder() as dtw, contextlib.redirect_stdout(printed):
        out = run_asr.main(argv)
    torch.cuda.synchronize()
    return {"out": out, "printed": printed.getvalue(),
            "wall": time.perf_counter() - t0, "dtw": dtw,
            "launches": (logmel.LOGMEL_LAUNCHES, attn.ATTN_LAUNCHES,
                         mega.MEGA_LAUNCHES),
            "dtw_calls": native_lib.DTW_CALLS, "calls": list(results)}


def phase_asr(model, smi: str) -> None:
    """[ASR] The offline CLI, ``python -m thewhisper_tpu_torch.run_asr``, on
    the card at full width. The bf16 turbo model of the main path is
    written with ``save_hf_checkpoint`` (f32 on disk, so bf16 weights come
    back bit for bit) and split into two shards and HF's index. ``--model-size
    XL`` on the 70 s WAV with ``--srt``: text and word chunks equal, bit for
    bit, to an ``ASRPipeline`` over the in-memory model with the engine
    options ``from_checkpoint`` gives it, on the same WAV and arguments; K1
    once an engine call, K2 once an encoder layer of each; the SRT cues
    parse and lie within the audio; DTW ran in the host runtime
    (``native_lib.DTW_CALLS``). ``--model-size S`` on the 20 s WAV (batch
    1, cold): K3 once a step call, plus the one warm-up step of each decode
    program it captured; ordered cues. Then the native DTW against its
    plain version on both calls' matrices and on 100 of a 9 s window's
    shape (paths equal, ms each), and, where ffmpeg is installed, a FLAC
    of the 20 s WAV through ``load_audio`` against the WAV."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    results: list = []
    generate = WhisperEngine._generate

    def recording(self, *a, **k):
        res = generate(self, *a, **k)
        results.append((self, res))
        return res

    WhisperEngine._generate = recording
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            ckpt = Path(tmp) / "large-v3-turbo"
            t0 = time.perf_counter()
            save_hf_checkpoint(model, model.arch, str(ckpt))
            shards = shard_safetensors(str(ckpt), 2)
            print(f"[ASR] checkpoint written and split into {len(shards)} shards "
                  f"and an index in {time.perf_counter() - t0:.2f} s", flush=True)
            wav70, wav20 = Path(tmp) / "speech70.wav", Path(tmp) / "speech20.wav"
            write_wav(wav70, synth_audio(70, seed=2))
            write_wav(wav20, synth_audio(20, seed=1))
            common = ["--model", str(ckpt), "--max-new-tokens", str(ASR_TOKENS)]

            srt70 = Path(tmp) / "speech70.srt"
            xl = run_cli([str(wav70), *common, "--model-size", "XL", "--srt",
                          str(srt70)], results)
            with open(ckpt / "generation_config.json") as f:
                gen = json.load(f)
            pipe = ASRPipeline(WhisperEngine(
                model, suppress_tokens=gen.get("suppress_tokens", []) or [],
                begin_suppress_tokens=gen.get("begin_suppress_tokens", []) or []),
                chunk_length_s=30)
            ref = pipe(str(wav70), return_timestamps="word", chunk_length_s=29,
                       generate_kwargs={"num_beams": 1, "language": "en",
                                        "max_new_tokens": ASR_TOKENS})
            del pipe
            calls = len(xl["calls"])
            check(xl["out"]["text"] == ref["text"]
                  and xl["out"]["chunks"] == ref["chunks"],
                  "[ASR] XL: the CLI's text or word chunks differ from the "
                  "in-memory pipeline's")
            check(xl["launches"] == (calls, calls * model.arch.encoder_layers, 0),
                  f"[ASR] XL: launches K1, K2, K3 {xl['launches']} over {calls} "
                  "engine calls")
            check(xl["dtw_calls"] == len(xl["dtw"].costs) > 0,
                  f"[ASR] XL: native DTW calls {xl['dtw_calls']}")
            check_word_chunks(xl["out"], 70.0, ordered=False)
            cues70 = check_srt(srt70, 70.0, ordered=False)
            print(f"[ASR] --model-size XL, 70 s WAV: text and {len(ref['chunks'])} "
                  f"word chunks equal to the in-memory pipeline's, bit for bit; "
                  f"{calls} engine calls, launches K1, K2, K3 {xl['launches']}; "
                  f"{xl['dtw_calls']} native DTW calls, "
                  f"{xl['dtw'].seconds * 1e3:.2f} ms; {cues70} SRT cues; "
                  f"{xl['printed'].strip().splitlines()[-1]}, wall with the "
                  f"checkpoint load {xl['wall']:.2f} s; {smi}", flush=True)

            srt20 = Path(tmp) / "speech20.srt"
            s20 = run_cli([str(wav20), *common, "--model-size", "S", "--srt",
                           str(srt20)], results)
            engine = s20["calls"][0][0]
            check(engine.model.mega is not None, "[ASR] S: K3's operands not packed")
            steps = sum(r.decode_steps for _, r in s20["calls"])
            captured = sum(p["graph"] for p in engine.programs())
            calls = len(s20["calls"])
            check(all(r.tokens.shape[0] == 1 for _, r in s20["calls"]),
                  "[ASR] S: a call not at batch 1")
            check(steps > 0 and s20["launches"] == (
                calls, calls * model.arch.encoder_layers, steps + captured),
                f"[ASR] S: launches K1, K2, K3 {s20['launches']}, {calls} engine "
                f"calls, {steps} step calls, {captured} programs captured")
            check(s20["dtw_calls"] == len(s20["dtw"].costs) > 0,
                  f"[ASR] S: native DTW calls {s20['dtw_calls']}")
            check_word_chunks(s20["out"], 20.0, ordered=True)
            cues20 = check_srt(srt20, 20.0, ordered=True)
            print(f"[ASR] --model-size S, 20 s WAV, batch 1: {steps} step calls, "
                  f"launches K1, K2, K3 {s20['launches']} (K3 once a step call and "
                  f"once for each of the {captured} programs' warm-up step); "
                  f"{len(s20['out']['chunks'])} words, {cues20} ordered SRT cues; "
                  f"{s20['printed'].strip().splitlines()[-1]}; {smi}", flush=True)
            del engine
            results.clear()

            costs = xl["dtw"].costs + s20["dtw"].costs
            native_ms, plain_ms = dtw_against_plain(costs)
            print(f"[ASR] DTW on the two calls' {len(costs)} matrices "
                  f"({', '.join(str(c.shape) for c in costs)}): native "
                  f"{native_ms:.2f} ms, plain {plain_ms:.2f} ms, paths equal",
                  flush=True)
            rng = np.random.default_rng(0)
            windows = [rng.standard_normal(DTW_WINDOW) for _ in range(100)]
            native_ms, plain_ms = dtw_against_plain(windows)
            print(f"[ASR] DTW on 100 matrices of a 9 s window's shape "
                  f"{DTW_WINDOW}: native {native_ms / 100:.3f} ms a window, plain "
                  f"{plain_ms / 100:.3f} ms a window ({plain_ms / native_ms:.1f}x), "
                  f"paths equal; host CPU", flush=True)

            exe = shutil.which("ffmpeg")
            if exe is None:
                print("[ASR] ffmpeg: not on this machine's PATH; the non-WAV "
                      "route of load_audio was not run", flush=True)
            else:
                flac = Path(tmp) / "speech20.flac"
                subprocess.run([exe, "-v", "error", "-y", "-i", str(wav20), str(flac)],
                               check=True, timeout=60)
                got, want = load_audio(str(flac)), load_audio(str(wav20))
                err = float(np.abs(got - want).max()) if got.shape == want.shape else None
                check(err is not None and err <= 1e-6,
                      f"[ASR] ffmpeg: FLAC {got.shape} against WAV {want.shape}, "
                      f"max abs err {err}")
                print(f"[ASR] ffmpeg: a FLAC of the 20 s WAV through load_audio "
                      f"equals the WAV ({len(got)} samples, max abs err {err:.1e})",
                      flush=True)
    finally:
        WhisperEngine._generate = generate
        results.clear()
    torch.cuda.empty_cache()
    print(f"[ASR] phase {time.perf_counter() - t_phase:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB", flush=True)


LONGFORM_SECONDS = 600
LONGFORM_KW = {"language": "en", "max_new_tokens": 32}
LONGFORM_TURNS = 2       # timed calls of each arm, in turns, after a warm one


def longform_arms(model, quantized: bool) -> dict:
    """The bench's long-form arms (``bench.py`` 355-520) on ``model``:
    10 s pipelines, 9 s call windows on a 9 s latency bucket, EOT
    suppressed by an engine of its own. Name -> (pipeline, batch size)."""
    eot = SpecialTokens.for_vocab(model.arch.vocab_size).eot
    engine = WhisperEngine(model, cross_kv_int8=quantized, suppress_tokens=[eot])

    def pipe(**kw):
        return ASRPipeline(engine, chunk_length_s=10, latency_buckets=[9.0],
                           pipeline_depth=kw.pop("depth"), **kw)

    if not quantized:
        return {"bf16 B32 depth 2": (pipe(depth=2), 32)}
    return {"S B1 depth 0": (pipe(depth=0), 1),
            "S B1 depth 2 wpp 4": (pipe(depth=2, windows_per_program=4), 1),
            "S B32 depth 2 wpp 3 first-window": (pipe(
                depth=2, windows_per_program=3, first_window_fast=True), 32)}


def longform_call(pipe, bsz: int, audio: np.ndarray, **kw) -> dict:
    """One 600 s call with the launches zeroed just before: its wall, its
    first result's seconds, K1/K2/K3 launches, the engine calls it
    dispatched (rows each), the window-0 handle's result, and the host
    seconds spent queueing encoders (featurizer and encoder launches) and
    in the decode loops."""
    engine = pipe.engine
    rows, firsts = [], []
    host = {"encode": 0.0, "decode": 0.0}

    def timing(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name] += time.perf_counter() - t
        return run

    dispatch, window = engine._dispatch, engine.transcribe_window_async
    engine._dispatch = lambda x, *a, **k: rows.append(x.shape[0]) or dispatch(x, *a, **k)
    engine.transcribe_window_async = lambda *a, **k: firsts.append(window(*a, **k)) or firsts[-1]
    engine._decode = timing("decode", engine._decode)
    encode = PendingResult.encode
    PendingResult.encode = timing("encode", encode)
    torch.cuda.synchronize()
    logmel.LOGMEL_LAUNCHES = attn.ATTN_LAUNCHES = mega.MEGA_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        out = pipe(audio, chunk_length_s=9, generate_kwargs=dict(LONGFORM_KW),
                   batch_size=bsz, **kw)
        torch.cuda.synchronize()
    finally:
        del engine._dispatch, engine.transcribe_window_async, engine._decode
        PendingResult.encode = encode
    return {"out": out, "wall": time.perf_counter() - t0,
            "first": pipe.last_first_result_s, "rows": rows, "host": host,
            "window0": firsts[0].result() if firsts else None,
            "launches": (logmel.LOGMEL_LAUNCHES, attn.ATTN_LAUNCHES,
                         mega.MEGA_LAUNCHES)}


def check_longform_launches(name: str, run: dict, model) -> None:
    """K1 once an engine call, K2 once an encoder layer of each, K3 every
    step call at batch 1 of a K3 engine (a window's 31 steps, rounded up to
    the host checks, replays counted)."""
    calls = len(run["rows"])
    steps = STEPS_PER_CHECK * math.ceil((LONGFORM_KW["max_new_tokens"] - 1)
                                        / STEPS_PER_CHECK)
    k3 = steps * run["rows"].count(1) if model.mega is not None else 0
    want = (calls, calls * model.arch.encoder_layers, k3)
    check(run["launches"] == want,
          f"[LONGFORM] {name}: launches K1, K2, K3 {run['launches']} != {want}")


def longform_kernels_against_plain(engine, full, offsets, bucket) -> None:
    """K1 on the path's 9 s windows (B = 32) and K2 on layer 0's q, k, v
    at S = 450 against their plain versions, [K1]'s and [K2]'s bounds."""
    x = engine._window_audio(full, offsets[:32], 9 * SAMPLE_RATE, bucket)
    captured = []

    def first_layer(q, k, v):
        if not captured:
            captured.append((q, k, v))
        return attn.encoder_attention(q, k, v)

    with torch.inference_mode():
        mel = log_mel_spectrogram(x, engine._mel_fb, engine._window)
        ref = log_mel_spectrogram_plain(x, engine._mel_fb, engine._window)
        k1_err = (mel - ref).abs().max().item()
        encoder_forward(engine.model, mel, attention=first_layer)
        q, k, v = captured[0]
        out = attn.encoder_attention(q, k, v)
        ref = attn.encoder_attention_plain(q, k, v)
        k2_rel = ((out.float() - ref.float()).abs().max()
                  / out.float().abs().max()).item()
    check(mel.shape == (32, engine.arch.n_mels, 900) and k1_err <= 5e-4,
          f"[LONGFORM] K1 at 9 s: shape {tuple(mel.shape)}, err {k1_err}")
    check(q.shape[1] == 450 and k2_rel <= 2e-2,
          f"[LONGFORM] K2 at S = {q.shape[1]}: rel err {k2_rel}")
    print(f"[LONGFORM] on the path's inputs: K1 B=32 x 9 s max abs err "
          f"{k1_err:.3e}; K2 {str(q.dtype)[6:]} B=32 S={q.shape[1]} max abs "
          f"err relative to the output's max {k2_rel:.3e}", flush=True)


def phase_longform(model, smi: str, quantized: bool) -> dict:
    """[LONGFORM] The bench's long-form protocol through the port's
    pipeline: a 600 s file, 9 s windows on a 9 s bucket, 32 new tokens,
    EOT suppressed. bf16 turbo (``quantized`` False) at batch 32, depth 2,
    and one batch-32 call with word timestamps (DTW on the offset path); or
    turbo "S" at batch 1 depth 0, batch 1 depth 2 in groups of 4 windows,
    and batch 32 depth 2 in groups of 3 batches with the first-window fast
    path. Each arm warm once, then ``LONGFORM_TURNS`` timed calls in turns:
    wall, RTFx, first result, K1/K2/K3 launches (checked). The batch-1
    arms give the same text; window 0 of the fast path equals a batch-1
    ``transcribe_window_async`` of it, bit for bit. Returns the arms,
    warmed: name -> (pipeline, batch size)."""
    t_phase = time.perf_counter()
    audio = synth_audio(LONGFORM_SECONDS, seed=60)
    arms = longform_arms(model, quantized)
    engine = next(iter(arms.values()))[0].engine
    for pipe, bsz in arms.values():
        # Warm: captures each key's graph (its warm-up step is one more K3).
        longform_call(pipe, bsz, audio)
    runs = {name: [] for name in arms}
    for _ in range(LONGFORM_TURNS):
        for name, (pipe, bsz) in arms.items():
            run = longform_call(pipe, bsz, audio)
            check_longform_launches(name, run, model)
            check(run["out"]["text"].strip() != "", f"[LONGFORM] {name}: no text")
            runs[name].append(run)
    for name, rs in runs.items():
        first = [r["first"] for r in rs if r["first"] is not None]
        print(f"[LONGFORM] {name}: walls "
              f"{', '.join(f'{r['wall']:.3f}' for r in rs)} s, RTFx "
              f"{', '.join(f'{LONGFORM_SECONDS / r['wall']:.1f}' for r in rs)}, "
              f"first result "
              f"{', '.join(f'{s:.4f}' for s in first) if first else 'n/a'} s; "
              f"K1, K2, K3 launches {rs[-1]['launches']} over "
              f"{len(rs[-1]['rows'])} engine calls (rows {sorted(set(rs[-1]['rows']))}); "
              f"host seconds queueing encoders "
              f"{', '.join(f'{r['host']['encode']:.3f}' for r in rs)}, in the "
              f"decode loops {', '.join(f'{r['host']['decode']:.3f}' for r in rs)}; "
              f"{smi}", flush=True)
    texts = {name: rs[-1]["out"]["text"] for name, rs in runs.items()}
    win_model = 10 * SAMPLE_RATE
    full = to_device(audio, engine.device, length=len(audio) + win_model)
    offsets = ASRPipeline._window_offsets(len(audio), 9 * SAMPLE_RATE,
                                          6 * SAMPLE_RATE)
    bucket = 9 * SAMPLE_RATE
    if quantized:
        b1 = [texts[n] for n in arms if " B1 " in n]
        check(b1[0] == b1[1], "[LONGFORM] the batch-1 arms' texts differ")
        fast = [rs[-1] for n, rs in runs.items() if "first-window" in n][0]
        one = engine.transcribe_window_async(
            full, 0, 9 * SAMPLE_RATE, bucket, GenerationOptions(**LONGFORM_KW)).result()
        for field in ("tokens", "num_generated", "sum_logprob", "token_logprobs"):
            check(np.array_equal(getattr(fast["window0"], field), getattr(one, field)),
                  f"[LONGFORM] window 0 of the fast path: {field} differs from "
                  "a batch-1 transcribe_window_async")
        print(f"[LONGFORM] batch-1 texts equal; window 0 of the fast path equals "
              f"a batch-1 transcribe_window_async, bit for bit; batch 32 "
              f"merged text {'equals' if texts[list(arms)[-1]] == b1[0] else 'differs from'} "
              f"batch 1's (bf16 GEMMs of other shapes)", flush=True)
    else:
        # Word timestamps: the first call captures its programs, the second
        # is timed beside the plain DTW on the same matrices.
        pipe, bsz = arms["bf16 B32 depth 2"]
        for call in (1, 2):
            with DtwRecorder() as dtw:
                run = longform_call(pipe, bsz, audio, return_timestamps="word")
            check_word_chunks(run["out"], LONGFORM_SECONDS, ordered=False)
            check(len(dtw.costs) > 0, "[LONGFORM] no DTW with word timestamps")
            shown = ""
            if call == 2:
                native_ms, plain_ms = dtw_against_plain(dtw.costs)
                shown = (f"; again on the same {len(dtw.costs)} matrices: native "
                         f"{native_ms:.1f} ms, the plain numpy sweep "
                         f"{plain_ms:.1f} ms, paths equal")
            print(f"[LONGFORM] bf16 B32 with word timestamps (DTW on the "
                  f"offset path), call {call}: wall {run['wall']:.3f} s, RTFx "
                  f"{LONGFORM_SECONDS / run['wall']:.1f}, "
                  f"{len(run['out']['chunks'])} words; host seconds in the "
                  f"native DTW {dtw.seconds:.4f} over {len(dtw.costs)} "
                  f"windows{shown}; {smi}", flush=True)
    longform_kernels_against_plain(engine, full, offsets, bucket)
    print(f"[LONGFORM] reference H100 turbo \"S\" (SURVEY §6, context only): "
          f"bs=1 RTFx 161.45, bs=64 2016.18; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return arms


def phase_turbo_s(model, smi: str) -> WhisperEngine:
    """[turbo S] The turbo model quantized in place as ``"int8-all"`` (int8
    decoder and table, W8A8 encoder), ``WhisperEngine(cross_kv_int8=True)``:
    the 20 s WAV at batch 1 with word timestamps, twice, each with K3's
    count zeroed just before (the engine warmed first, as a server warms
    it, so no call captures). Every step call of the loop must be one K3
    launch (``mega_pays`` at batch 1 for any depth), replayed from the
    loop's CUDA graph. Then [GRAPH] on that engine's K3 route at batch 1:
    graph against eager (``graph_vs_eager``). Returns the engine."""
    quantize_params(model, components=("decoder",))
    quantize_params(model, components=("encoder",), activation_int8=True)
    engine = WhisperEngine(model, cross_kv_int8=True)
    check(model.mega is not None, "the turbo S engine did not pack K3's operands")
    engine.warmup(3000, (1,), GEN_KW["max_new_tokens"], True)
    pipe = ASRPipeline(engine, chunk_length_s=30)
    results = []
    generate = engine._generate
    engine._generate = lambda *a, **k: results.append(generate(*a, **k)) or results[-1]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        wav20 = Path(tmp) / "speech20.wav"
        write_wav(wav20, synth_audio(20, seed=6))
        for run in (1, 2):
            mega.MEGA_LAUNCHES = 0
            r20 = timed(f"turbo S, 20 s WAV, word timestamps, batch 1, call {run}",
                        lambda: pipe(str(wav20), return_timestamps="word",
                                     generate_kwargs=dict(GEN_KW)), tag="turbo S")
            launches = mega.MEGA_LAUNCHES
            res = results[-1]
            steps = res.decode_steps
            check(steps > 0 and launches == steps,
                  f"turbo S: K3 launches {launches} != {steps} step calls")
            check_word_chunks(r20, 20.0, ordered=True)
            check(bool(np.isfinite(res.token_logprobs).all()
                       and np.isfinite(res.align).all()), "turbo S result not finite")
            print(f"[turbo S] call {run}: {len(r20['chunks'])} words, {steps} "
                  f"step calls, K3 launches {launches}", flush=True)
    engine._generate = generate
    graph_vs_eager("GRAPH turbo S", model, 1, smi, cross_kv_int8=True)
    sampled_graph_vs_eager("GRAPH turbo S", model, 1, smi, cross_kv_int8=True)
    return engine


RESULT_FIELDS = ("tokens", "num_generated", "sum_logprob", "token_logprobs",
                 "no_speech_prob", "align")


def prompt_rows(engine: WhisperEngine, rows: int) -> torch.Tensor:
    return torch.tensor([engine.build_prompt("en")] * rows,
                        device=engine.device)


def loop_ms(engine: WhisperEngine, key: tuple, reps: int = 5):
    """The decode alone: the loop of ``key``'s program (after an eager
    prefill of the English prompt on the cross K/V its last call left),
    host clock around ``torch.cuda.synchronize``, p50 of ``reps``, in ms a
    step call; and the step calls a run made. Graph engines replay."""
    prog = engine._programs[key]
    replay = prog.graph.replay if prog.graph is not None else None
    prompt = prompt_rows(engine, key[0])
    times, steps = [], 0
    with torch.inference_mode():
        for _ in range(reps):
            prog.loop.start(prompt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = prog.loop.run(STEPS_PER_CHECK, replay=replay)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / steps)
    return float(np.median(times)), steps


def replay_ms(engine: WhisperEngine, key: tuple) -> float:
    """Device time of one step from a replay of ``key``'s graph (CUDA
    events around one replay of ``STEPS_PER_CHECK`` steps; the loop's state
    as its last run left it, so every step does a step's work and writes
    nothing)."""
    graph = engine._programs[key].graph
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * STEPS_PER_CHECK)


def graph_vs_eager(tag: str, model, batch: int, smi: str, beams: int = 1,
                   cross_kv_int8: bool = False) -> dict:
    """One engine with CUDA graphs, warmed for 30 s windows at ``batch``
    (``WhisperEngine.warmup``), and one without on the same model; then one
    call each on the same ``batch`` x 30 s of audio, 64 new tokens, word
    timestamps: every output field must be equal, bit for bit. Prints each
    route's ms a step (``loop_ms``), the graph's device ms a step
    (``replay_ms``) and the key's capture time and device memory; on the
    K3 route, K3's launches in each engine's call must equal the step
    calls its loop ran (``tools/decode_step_probe.py`` profiles the
    replayed steps). Returns the numbers."""
    kw = dict(cross_kv_int8=cross_kv_int8)
    engines = {"graph": WhisperEngine(model, **kw),
               "eager": WhisperEngine(model, cuda_graphs=False, **kw)}
    feat = LogMelFeaturizer(n_mels=model.arch.n_mels, device=model.device)
    mel = feat([synth_audio(30, seed=90 + i) for i in range(batch)])
    opts = GenerationOptions(language="en", max_new_tokens=64, num_beams=beams,
                             return_timestamps=True)
    results, out = {}, {}
    # The graph engine warmed, so that its call captures nothing (the
    # capture's warm-up step launches K3 eagerly); the eager one needs none.
    engines["graph"].warmup(3000, (batch,), 64, True, num_beams=beams)
    for name, engine in engines.items():
        mega.MEGA_LAUNCHES = 0
        results[name] = engine.transcribe_features(mel, opts)
        out[f"{name}_k3"] = mega.MEGA_LAUNCHES
    g, e = results["graph"], results["eager"]
    for field in RESULT_FIELDS:
        check(np.array_equal(getattr(g, field), getattr(e, field)),
              f"{tag}: graph and eager {field} differ")
    check(bool(np.isfinite(g.token_logprobs).all() and np.isfinite(g.align).all()),
          f"{tag}: result not finite")
    (key, prog), = [(p["key"], p) for p in engines["graph"].programs()]
    check(prog["graph"], f"{tag}: no graph captured")
    if engines["graph"].model.mega is not None and batch * beams == 1:
        # The eager loop stops at max_new - 1 step calls; the graph runs
        # whole replays of STEPS_PER_CHECK.
        check(out["graph_k3"] == g.decode_steps
              and out["eager_k3"] == e.decode_steps,
              f"{tag}: K3 launches {out['graph_k3']} (graph) / "
              f"{out['eager_k3']} (eager) != step calls {g.decode_steps} / "
              f"{e.decode_steps}")
    for name, engine in engines.items():
        out[f"{name}_ms"], out["steps"] = loop_ms(engine, key)
    out["device_ms"] = replay_ms(engines["graph"], key)
    out["capture_s"], out["bytes"] = prog["seconds"], prog["bytes"]
    out["result"] = g
    print(f"[{tag}] key {key}: graph == eager (tokens, num_generated, "
          f"sum_logprob, token_logprobs, no_speech_prob, align), "
          f"{int(g.num_generated.min())}-{int(g.num_generated.max())} tokens, "
          f"{g.decode_steps} step calls; decode alone (host clock, p50 of 5) "
          f"{out['graph_ms']:.4f} ms a step from the graph, "
          f"{out['eager_ms']:.4f} eager ({out['eager_ms'] / out['graph_ms']:.2f}x); "
          f"device {out['device_ms']:.4f} ms a step (graph replay); capture "
          f"{out['capture_s']:.3f} s, {out['bytes'] / 2 ** 20:.1f} MiB for the "
          f"key (buffers and graph pool); {smi}", flush=True)
    return out


def phase_graph(model, smi: str) -> dict:
    """[GRAPH] bf16 large-v3-turbo at full width, 30 s windows, 64 new
    tokens: the greedy loop from CUDA graphs against the same loop eager
    (``graph_vs_eager``) at batch 1 and at batch 3 (padded to bucket 4),
    then a sampled call of each (``sampled_graph_vs_eager``)."""
    out = {b: graph_vs_eager("GRAPH", model, b, smi) for b in (1, 3)}
    for b in (1, 3):
        sampled_graph_vs_eager("GRAPH", model, b, smi)
    return out


def sampled_graph_vs_eager(tag: str, model, batch: int, smi: str,
                           cross_kv_int8: bool = False) -> dict:
    """Sampled calls (64 new tokens, word timestamps, 30 s windows) on an
    engine with CUDA graphs and on one without: seeds 3 and 4 at
    temperature 0.7, then seed 3 at 0.3 (the next rung of a fallback
    ladder). Each call's result from the graph must equal the eager one,
    bit for bit, the two seeds' tokens differ, and one program serves the
    three calls (its generator registered with the graph, its temperature
    a device scalar). On the K3 route K3 must launch once a step call.
    Prints each call's wall and the program's capture time and memory."""
    kw = dict(cross_kv_int8=cross_kv_int8)
    engines = {"graph": WhisperEngine(model, **kw),
               "eager": WhisperEngine(model, cuda_graphs=False, **kw)}
    feat = LogMelFeaturizer(n_mels=model.arch.n_mels, device=model.device)
    mel = feat([synth_audio(30, seed=90 + i) for i in range(batch)])
    arms = ((3, 0.7), (4, 0.7), (3, 0.3))
    out, walls = {}, {}
    for arm in arms:
        seed, temp = arm
        opts = GenerationOptions(language="en", max_new_tokens=64,
                                 return_timestamps=True, temperature=temp,
                                 seed=seed)
        for name, engine in engines.items():
            mega.MEGA_LAUNCHES = 0
            t0 = time.perf_counter()
            res = out[name, arm] = engine.transcribe_features(mel, opts)
            walls[name, arm] = time.perf_counter() - t0
            # The graph engine's first call captures: its warm-up step
            # launches K3 once, eagerly.
            warm = int(name == "graph" and arm == arms[0])
            if model.mega is not None and batch == 1:
                check(mega.MEGA_LAUNCHES == res.decode_steps + warm,
                      f"{tag} sampled: K3 launches {mega.MEGA_LAUNCHES} != "
                      f"{res.decode_steps} step calls")
        for field in RESULT_FIELDS:
            check(np.array_equal(getattr(out["graph", arm], field),
                                 getattr(out["eager", arm], field)),
                  f"{tag} sampled, seed {seed} at {temp}: graph and eager "
                  f"{field} differ")
        check(bool(np.isfinite(out["graph", arm].token_logprobs).all()),
              f"{tag} sampled: logprobs not finite")
    check(not np.array_equal(out["graph", arms[0]].tokens,
                             out["graph", arms[1]].tokens),
          f"{tag} sampled: seeds 3 and 4 drew the same tokens")
    (prog,) = engines["graph"].programs()
    check(prog["graph"] and prog["key"][6] is True, f"{tag} sampled: no graph")
    timings = "; ".join(
        f"seed {s} at {t}: {walls['graph', (s, t)]:.3f} s from the graph, "
        f"{walls['eager', (s, t)]:.3f} s eager" for s, t in arms)
    print(f"[{tag}] sampled, batch {batch}, key {prog['key']}: graph == eager "
          f"for each call (every field), seeds 3 and 4 draw other tokens; "
          f"{out['graph', arms[0]].decode_steps} step calls; call wall "
          f"(the first with its capture) {timings}; capture and buffers "
          f"{prog['seconds']:.3f} s, {prog['bytes'] / 2 ** 20:.1f} MiB; {smi}",
          flush=True)
    return out


def phase_beam(model, smi: str) -> dict:
    """[BEAM] bf16 large-v3-turbo, batch 2 x 4 beams, word timestamps: the
    beam loop from CUDA graphs against the same loop eager, bit for bit;
    the best beam's sum_logprob equals the sum of its token_logprobs to
    1e-4 relative."""
    out = graph_vs_eager("BEAM", model, 2, smi, beams=4)
    res = out["result"]
    total = res.token_logprobs.astype(np.float64).sum(-1)
    gap = np.abs(total - res.sum_logprob) / np.maximum(1.0, np.abs(res.sum_logprob))
    check(float(gap.max()) <= 1e-4, f"BEAM: best beams' sum_logprob "
          f"{res.sum_logprob} against their token_logprobs' sums {total}")
    print(f"[BEAM] best beams' sum_logprob {res.sum_logprob.tolist()}, their "
          f"token_logprobs summed within {float(gap.max()):.2e} (relative)",
          flush=True)
    return out


def percentiles(ms) -> str:
    p50, p95 = np.percentile(ms, [50, 95])
    return f"p50 {p50:.1f} ms, p95 {p95:.1f} ms, max {max(ms):.1f} ms"


def speech_and_silence(seconds: int, seed: int) -> np.ndarray:
    """5 s of ``synth_audio`` speech alternating with 5 s of near-silence
    (the neural VAD passes the first and gates the second)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        synth_audio(5, seed + i) if i % 2 == 0
        else (0.0005 * rng.standard_normal(5 * SAMPLE_RATE)).astype(np.float32)
        for i in range(seconds // 5)])


def phase_stream(engine: WhisperEngine, smi: str) -> None:
    """[STREAM] One turbo "S" session: ``StreamingPipeline`` over
    ``LocalWhisperBackend(ASRPipeline(engine, chunk_length_s=10))`` with
    the default (neural) VAD, fed 30 s of speech and near-silence in
    0.05 s chunks, not in real time; with cross-tick reuse (the backend's
    default), then without. Each tick featurizes once (K1) and encodes a
    10 s window (K2 in each encoder layer); a greedy tick (every tick
    without reuse, the first with it) decodes through K3, a drafted one
    through the plain verify (K4 serves no alignment). ``max_new_tokens``
    64, as ``GEN_KW``: the random model's text then repeats itself and the
    gibberish gate empties the ticks. A third arm, with reuse, decodes
    ``WORD_TOKENS`` a tick, which keeps the text under the gate: it must
    commit words, so the commits, trims and word dedup run at full width
    and the order and clock checks hold real words. First the W8A8
    encoder's wall on 10 s windows at B = 1 and 3 (a lone stream's tick,
    three coalesced sessions') and on one 30 s window (the same rows as
    B = 3 at 10 s), then B = 1 at 10 s again (whether the first reading
    held a one-time cost), host clock, median of 5."""
    # Built under inference mode, as a caller inside it builds them: the
    # log-mel table cache keys an inference filter bank without a version
    # counter (it has none), so K1 takes them.
    with torch.inference_mode():
        featurizers = {s: ASRPipeline(engine, chunk_length_s=s).featurizer
                       for s in (10, 30)}
        check(featurizers[10].mel_fb.is_inference(), "featurizer not built "
              "under inference mode")
        k1_before = logmel.LOGMEL_LAUNCHES
        for b, seconds in ((1, 10), (3, 10), (1, 30), (1, 10)):
            mel = featurizers[seconds]([synth_audio(seconds, seed=70 + i)
                                        for i in range(b)])
            encoder_forward(engine.model, mel)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                encoder_forward(engine.model, mel)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            print(f"[STREAM] W8A8 encoder with K2, B={b} x {seconds} s, median of 5: "
                  f"{sorted(times)[2]:.2f} ms; {smi}", flush=True)
    check(logmel.LOGMEL_LAUNCHES == k1_before + 4,
          "the featurizers built in inference mode did not run K1")
    # The ticks' programs (CUDA graphs), greedy and drafted, made before
    # the sessions, as a server makes them: no tick captures, so a tick's
    # K3 launches are the step calls its loop ran.
    # The same engine without graphs beside it: reuse on, eagerly.
    eager = WhisperEngine(engine.model, cross_kv_int8=True, cuda_graphs=False)
    for max_new in (GEN_KW["max_new_tokens"], WORD_TOKENS):
        engine.warmup(1000, (1,), max_new, True, proposals=True)
    eager.warmup(1000, (1,), GEN_KW["max_new_tokens"], True, proposals=True)
    for reuse in (True, False):
        stream_session(engine, reuse, smi, GEN_KW["max_new_tokens"])
    stream_session(eager, True, smi, GEN_KW["max_new_tokens"])
    stream_session(engine, True, smi, WORD_TOKENS)


def phase_padded_rows(engine: WhisperEngine, smi: str) -> None:
    """[PAD] What a padded row costs a speculative call (JAX's padding,
    kept): the turbo "S" engine's proposals call at batch 3, padded to
    bucket 4 with a zero row (zero audio, zero proposals), as the server
    sends three coalesced drafted ticks, against the same call on an
    engine whose buckets hold 3, which pads nothing; then the zero row
    alone at batch 1. Three 10 s windows, 64 new tokens, word timestamps;
    each engine's proposals are its own greedy tokens of the rows (a tick
    whose audio repeats the last one's). Each call, greedy and drafted,
    made once (capturing its program if it has none), then timed three
    times (host clock, median): rounds and call walls, and the rows'
    drafted tokens equal to the greedy call's on each engine."""
    unpadded = WhisperEngine(engine.model, cross_kv_int8=True,
                             batch_buckets=(1, 2, 3, 4))
    opts = GenerationOptions(language="en", return_timestamps=True,
                             max_new_tokens=GEN_KW["max_new_tokens"])
    audio = np.stack([synth_audio(10, seed=100 + i) for i in range(3)])
    zero = np.zeros_like(audio[:1])
    arms = (("batch 3, padded to bucket 4", engine, audio),
            ("batch 3, bucket 3", unpadded, audio),
            ("the zero row alone", engine, zero))

    def median_wall(eng, x, props):
        """The call's result and median wall of three, after a first call
        (which captures its program if it has none)."""
        eng.transcribe_audio(x, opts, draft_tokens=props)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.transcribe_audio(x, opts, draft_tokens=props)
            walls.append(time.perf_counter() - t0)
        return res, sorted(walls)[1]

    for name, eng, x in arms:
        greedy, greedy_s = median_wall(eng, x, None)
        props = (greedy.tokens[:, greedy.prompt_len:] if x is audio
                 else np.zeros((1, opts.max_new_tokens), np.int64))
        res, wall = median_wall(eng, x, props)
        if x is audio:
            check(np.array_equal(res.tokens, greedy.tokens),
                  f"[PAD] {name}: drafted tokens differ from greedy's")
        print(f"[PAD] {name}, proposals: {res.spec_rounds} rounds, tokens "
              f"{res.num_generated.tolist()}; call wall {wall:.4f} s, greedy "
              f"{greedy_s:.4f} s (host clock, median of 3); {smi}", flush=True)


# Tokens a tick in [STREAM]'s word arm.
WORD_TOKENS = 3


def stream_session(engine: WhisperEngine, reuse: bool, smi: str,
                   max_new: int) -> None:
    n_enc = engine.arch.encoder_layers
    pipe = ASRPipeline(engine, chunk_length_s=10, reuse_previous_tokens=reuse)
    backend = LocalWhisperBackend(pipe, chunk_length_s=10,
                                  max_new_tokens=max_new)
    raw, results = [], []
    backend.asr_pipeline = lambda *a, **k: raw.append(pipe(*a, **k)) or raw[-1]
    generate = engine._generate
    engine._generate = lambda *a, **k: results.append(generate(*a, **k)) or results[-1]
    sp = StreamingPipeline(backend=backend, chunk_length_s=10)
    check(type(sp.vad_model).__name__ == "NeuralVAD", "default VAD not neural")
    check(isinstance(sp._buffer, native_lib.RingBuffer),
          "the stream's rolling buffer is not the native ring")
    sp._buffer = ring = RingRecorder(sp._buffer)
    warmed = {p["key"] for p in engine.programs()}
    audio = speech_and_silence(30, seed=50)
    step = int(0.05 * SAMPLE_RATE)
    chunks = [audio[i: i + step] for i in range(0, len(audio), step)]
    ticks, committed, max_buffered = [], [], 0
    logmel.LOGMEL_LAUNCHES = attn.ATTN_LAUNCHES = 0
    mega.MEGA_LAUNCHES = mega.MEGA_VERIFY_LAUNCHES = 0
    try:
        with DtwRecorder() as dtw:
            for chunk in chunks:
                before = (logmel.LOGMEL_LAUNCHES, attn.ATTN_LAUNCHES,
                          mega.MEGA_LAUNCHES, sp.stats["chunks_processed"],
                          dtw.seconds, len(dtw.costs))
                t0 = time.perf_counter()
                c, _ = sp(chunk)
                wall = (time.perf_counter() - t0) * 1e3
                committed.extend(c)
                max_buffered = max(max_buffered, len(ring.buffer))
                if sp.stats["chunks_processed"] > before[3]:
                    ticks.append({"ms": wall, "k1": logmel.LOGMEL_LAUNCHES - before[0],
                                  "k2": attn.ATTN_LAUNCHES - before[1],
                                  "k3": mega.MEGA_LAUNCHES - before[2],
                                  "engine_ms": results[-1].decode_time_s * 1e3,
                                  "dtw_ms": (dtw.seconds - before[4]) * 1e3,
                                  "costs": dtw.costs[before[5]:],
                                  "res": results[-1], "out": raw[-1]})
    finally:
        engine._generate = generate
    tag = (f"reuse {'on' if reuse else 'off'}, {max_new} tokens"
           + ("" if engine.cuda_graphs else ", eager (cuda_graphs=False)"))
    check(len(ticks) == len(results) == len(raw), "one engine call a tick")
    made = {p["key"] for p in engine.programs()} - warmed
    check(not made, f"{tag}: ticks made programs {made} (captured live)")
    if max_new == WORD_TOKENS:
        check(len(committed) > 0, f"{tag}: no word committed")
    check(0 < sp.stats["chunks_processed"] < len(chunks),
          f"chunks_processed {sp.stats['chunks_processed']} of {len(chunks)}")
    check(max_buffered <= sp.window_size * SAMPLE_RATE,
          f"buffer held {max_buffered} samples, window {sp.window_size} s")
    starts = [w["start"] for w in committed]
    check(all(a <= b for a, b in zip(starts, starts[1:])),
          "committed starts out of order")
    check(all(t <= sp.current_time for t in starts),
          "a committed word starts after the stream's clock")
    for i, t in enumerate(ticks):
        check(t["k1"] == 1 and t["k2"] == n_enc,
              f"{tag}, tick {i}: K1 {t['k1']} / K2 {t['k2']} launches, "
              f"want 1 / {n_enc}")
        res = t["res"]
        check(bool(np.isfinite(res.token_logprobs).all()
                   and np.isfinite(res.align).all()), f"tick {i} not finite")
        steps = res.decode_steps
        greedy = res.spec_rounds is None
        check(greedy or reuse, f"{tag}, tick {i} decoded speculatively")
        check(t["k3"] == (steps if greedy else 0),
              f"{tag}, tick {i}: K3 launches {t['k3']}, {steps} step calls, "
              f"greedy {greedy}")
    check(ticks[0]["res"].spec_rounds is None and ticks[0]["k3"] > 0,
          "the first tick did not decode through K3")
    check(mega.MEGA_VERIFY_LAUNCHES == 0, "K4 launched on an alignment tick")
    gated = [compression_ratio(t["out"]["text"]) > GIBBERISH_THRESHOLD
             for t in ticks]
    worded = sum(bool(t["out"]["chunks"]) and not g
                 for t, g in zip(ticks, gated))
    drafted = [t for t in ticks if t["res"].spec_rounds is not None]
    per_round = (sum(int(t["res"].num_generated[0]) - 1 for t in drafted)
                 / max(1, sum(t["res"].spec_rounds for t in drafted)))
    print(f"[STREAM] turbo S, {tag}, 10 s windows, 30 s in {len(chunks)} "
          f"chunks of 0.05 s: {len(ticks)} ticks ({len(ticks) - len(drafted)} "
          f"greedy, {len(drafted)} drafted from the previous tick at "
          f"{per_round:.2f} tokens a verify round), {worded} with words, "
          f"{sum(gated)} emptied by the gibberish gate, {len(committed)} "
          f"words committed; buffer at most {max_buffered / SAMPLE_RATE:.2f} "
          f"s; launches K1 {logmel.LOGMEL_LAUNCHES}, K2 {attn.ATTN_LAUNCHES}, "
          f"K3 {mega.MEGA_LAUNCHES}, K4 {mega.MEGA_VERIFY_LAUNCHES}", flush=True)
    walls = [t["ms"] for t in ticks]
    print(f"[STREAM] {tag}, tick wall (host clock, the call that "
          f"transcribed): {percentiles(walls)} over {len(ticks)} ticks, "
          f"{len(drafted)} of them drafted (no tick made a program"
          f"{', each replayed its graph' if engine.cuda_graphs else ''}); "
          f"first (greedy, K3) "
          f"{walls[0]:.1f} ms; drafted ticks "
          f"{percentiles([t['ms'] for t in drafted]) if drafted else 'none'}; "
          f"of each tick the engine call (audio to the host copy of tokens "
          f"and alignment) {percentiles([t['engine_ms'] for t in ticks])}; "
          f"{smi}", flush=True)
    plain = [dtw_against_plain(t["costs"])[1] for t in ticks]
    print(f"[STREAM] {tag}, host time in the native DTW a tick: "
          f"{percentiles([t['dtw_ms'] for t in ticks])}; the plain numpy sweep "
          f"on the same matrices (paths equal): {percentiles(plain)}; "
          f"{smi}", flush=True)
    native_ms, plain_ms = ring_against_plain(ring.ops)
    print(f"[STREAM] {tag}, the rolling buffer's {len(ring.ops)} operations "
          f"of the session ({sum(op == 'write' for op, _ in ring.ops)} writes, "
          f"{sum(op == 'peek' for op, _ in ring.ops)} peeks) replayed: "
          f"native_lib.RingBuffer {native_ms:.3f} ms, streaming/ring.py "
          f"{plain_ms:.3f} ms (median of 3), every len and peek equal; "
          f"{smi}", flush=True)


class Session:
    """One server session over a keep-alive stdlib connection; ``manager``
    is the server's ``SessionManager``, read in process to tell the
    ``process`` calls that transcribed from those that found no tick."""

    def __init__(self, port: int, manager):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        self.sid = self.post("/session/create/")["session_id"]
        self.manager = manager

    def transcribed(self) -> int:
        """The session's ticks so far (its ``chunks_processed``)."""
        return self.manager.stats()["per_session"][self.sid]["chunks_processed"]

    def request(self, method: str, path: str) -> dict:
        self.conn.request(method, path)
        r = self.conn.getresponse()
        body = json.loads(r.read())
        check(r.status == 200, f"{method} {path.split('?')[0]}: {r.status} {body}")
        return body

    def post(self, path: str) -> dict:
        return self.request("POST", path)

    def stream(self, chunks, barrier=None):
        """add_chunk + process per chunk; returns the words of each process
        call and its wall in ms, the walls of the calls that transcribed
        (a tick) apart from those that did not."""
        ticks, walls = [], {"tick": [], "no tick": []}
        for chunk in chunks:
            b64 = base64.b64encode(chunk.astype(np.float32).tobytes()).decode()
            self.post(f"/session/{self.sid}/add_chunk?audio_data={quote(b64)}")
            if barrier is not None:
                barrier.wait(timeout=300)
            before = self.transcribed()
            t0 = time.perf_counter()
            out = self.post(f"/session/{self.sid}/process")
            wall = (time.perf_counter() - t0) * 1e3
            walls["tick" if self.transcribed() > before else "no tick"].append(wall)
            ticks.append([out["words"], out["uncommited_words"]])
        return ticks, walls

    def end(self) -> None:
        self.post(f"/session/{self.sid}/end")
        self.conn.close()


def phase_server(engine: WhisperEngine, smi: str) -> None:
    """[SERVER] The objects ``python -m thewhisper_tpu_torch.server`` builds
    (``server.launch.serve_pipeline``: kernels built and every batch size
    warmed, ``BatchedTranscriber`` with ``max_batch`` 4, ``SessionManager``,
    ``StreamingServer``) over ``ASRPipeline(engine, chunk_length_s=10,
    reuse_previous_tokens=True)``, on 127.0.0.1, port 0. Three sessions at
    once over stdlib HTTP (30 chunks of 0.1 s each, a barrier before each
    ``process``), ``/stats``, ``/health``, ``end``: every response 200, a
    coalesced batch above 1, K1 and K2 launched. Then one session alone,
    whose words must equal a ``StreamingPipeline``'s over a fresh
    transcriber fed the same chunks directly."""
    max_new = GEN_KW["max_new_tokens"]

    def recorded(asr):
        """(buffers, texts) of each ``transcribe_batch`` call of ``asr``."""
        calls, batch = [], asr.transcribe_batch

        def call(audios, **kwargs):
            out = batch(audios, **kwargs)
            calls.append(([np.array(a) for a in audios],
                          [r["text"] for r in out]))
            return out

        asr.transcribe_batch = call
        return calls

    asr = ASRPipeline(engine, chunk_length_s=10, reuse_previous_tokens=True)
    calls = recorded(asr)
    t0 = time.perf_counter()
    server, transcriber = serve_pipeline(
        asr, ServerConfig(host="127.0.0.1", port=0), max_batch=4,
        max_new_tokens=max_new)
    print(f"[SERVER] built and warmed (batches "
          f"{[len(a) for a, _ in calls]}) in "
          f"{time.perf_counter() - t0:.2f} s; {smi}", flush=True)
    base = synth_audio(3, seed=60)
    rng = np.random.default_rng(61)
    step = int(0.1 * SAMPLE_RATE)
    # One utterance with a little noise of its own a session: the VAD
    # flushes at the same chunks, so the sessions' ticks meet in a batch.
    streams = [np.split(
        (base + 0.005 * rng.standard_normal(len(base))).astype(np.float32),
        len(base) // step) for _ in range(3)]
    server.start_background()
    try:
        calls.clear()
        logmel.LOGMEL_LAUNCHES = attn.ATTN_LAUNCHES = mega.MEGA_LAUNCHES = 0
        barrier = threading.Barrier(3)
        walls, errors = {"tick": [], "no tick": []}, []

        def drive(chunks):
            try:
                session = Session(server.port, server.manager)
                _, w = session.stream(chunks, barrier)
                for k, v in w.items():
                    walls[k].extend(v)
                session.request("GET", "/stats")
                health = session.request("GET", "/health")
                check(health["backend"] == "cuda", f"/health: {health}")
                session.end()
            except Exception as e:  # re-raised below
                errors.append(e)
                barrier.abort()

        threads = [threading.Thread(target=drive, args=(s,)) for s in streams]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "a session thread hung")
        if errors:
            raise errors[0]
        launches = {"logmel": logmel.LOGMEL_LAUNCHES,
                    "encoder_attention": attn.ATTN_LAUNCHES,
                    "mega_step": mega.MEGA_LAUNCHES}
        sizes = [len(a) for a, _ in calls]
        check(max(sizes) > 1, f"no coalesced batch: sizes {sizes}")
        check(launches["logmel"] > 0 and launches["encoder_attention"] > 0,
              f"kernel launches on the server path {launches}")
        check(len(walls["tick"]) == sum(sizes),
              f"{len(walls['tick'])} process calls transcribed, "
              f"{sum(sizes)} buffers transcribed")
        print(f"[SERVER] three sessions, 30 x 0.1 s each: every response 200, "
              f"batches {sizes}, launches {launches}; process wall (host "
              f"clock, stdlib HTTP) of the {len(walls['tick'])} calls that "
              f"transcribed {percentiles(walls['tick'])}, of the "
              f"{len(walls['no tick'])} that found no tick "
              f"{percentiles(walls['no tick'])}; {smi}", flush=True)
        asr._prev_gen_tokens = None
        calls.clear()
        session = Session(server.port, server.manager)
        served, _ = session.stream(streams[0])
        session.end()
        served_calls = list(calls)
    finally:
        server.shutdown()
        transcriber.close()
    direct_asr = ASRPipeline(engine, chunk_length_s=10,
                             reuse_previous_tokens=True)
    direct_calls = recorded(direct_asr)
    direct_bt = BatchedTranscriber(direct_asr, max_new_tokens=max_new)
    try:
        sp = StreamingPipeline(backend=direct_bt.backend(), chunk_length_s=10)
        direct = [sp(c) for c in streams[0]]
    finally:
        direct_bt.close()
    # The buffers the engine saw and its texts as well as the words: with
    # random weights the gibberish gate may empty every tick's words.
    check(len(served_calls) == len(direct_calls) > 0
          and all(len(a) == len(b) == 1 and np.array_equal(a[0], b[0])
                  and t == u
                  for (a, t), (b, u) in zip(served_calls, direct_calls)),
          "the served session's buffers or texts differ from the direct "
          "pipeline's")
    check(json.loads(json.dumps(direct)) == served,
          "the served session's words differ from the direct pipeline's")
    n_words = sum(len(c) + len(a) for c, a in served)
    print(f"[SERVER] one session alone: its {len(served_calls)} buffers, "
          f"texts and words equal a StreamingPipeline's fed the same chunks "
          f"directly ({n_words} words over {len(served)} process calls)",
          flush=True)


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
    padded = np.zeros((1, 30 * SAMPLE_RATE), np.float32)
    padded[0, :len(audio)] = audio
    opts = GenerationOptions(language="en", max_new_tokens=32)
    beam_opts = GenerationOptions(language="en", max_new_tokens=32,
                                  num_beams=3, return_timestamps=True)
    outs, tokens, beams = [], [], []
    for model in (cpu_model, gpu_model):
        pipe = ASRPipeline(WhisperEngine(model), chunk_length_s=30)
        outs.append(pipe(audio, return_timestamps="word",
                         generate_kwargs={"language": "en",
                                          "max_new_tokens": 32}))
        # Greedy, ngram drafting and a one-layer layer-skip draft.
        for engine in (pipe.engine, WhisperEngine(model, spec_ngram=True),
                       WhisperEngine(model, draft_model=make_layer_skip_draft(
                           model, 1))):
            res = engine.transcribe_audio(padded, opts)
            tokens.append((res.tokens, res.spec_rounds))
        beams.append(pipe.engine.transcribe_audio(padded, beam_opts))
    check(outs[0] == outs[1], "small f32 model: card and CPU transcripts differ")
    check(np.array_equal(beams[0].tokens, beams[1].tokens)
          and np.array_equal(beams[0].num_generated, beams[1].num_generated),
          "small f32 model: card and CPU beam tokens differ")
    check(all(np.array_equal(t, tokens[0][0]) for t, _ in tokens),
          "small f32 model: speculative and greedy tokens differ")
    check(all((r is None) == (i % 3 == 0) for i, (_, r) in enumerate(tokens)),
          "small f32 model: speculation did not run where asked")
    print(f"[ref] small f32 model, 20 s: card == CPU ({len(outs[1]['chunks'])} "
          "words, identical text and word timestamps); greedy, ngram and "
          "layer-skip:1 tokens identical on both (verify rounds "
          f"{[r for _, r in tokens if r is not None]}); 3 beams: card == CPU "
          f"tokens ({int(beams[1].num_generated[0])} generated)", flush=True)


def phase_s_path():
    """The "S" main path at large-v3 width. Returns (model, the W8A8
    encoder's outputs, with K2, as the pipeline computes them, on one 30 s
    window and on one 10 s window (a streaming tick's), K3 launches of the
    batch-1 call). [K3] and [K4] take their cross K/V from those outputs:
    the production cross K/V."""
    dev = torch.device("cuda", 0)
    arch = dataclasses.replace(
        ARCH_PRESETS["large-v3"],
        # A few heads on the last decoder layers, so DTW has input.
        alignment_heads=((29, 4), (30, 11), (31, 3), (31, 17)))
    t0 = time.perf_counter()
    # Biases and LayerNorm parameters drawn at random, as a checkpoint has
    # them, so that K3's reads of them are checked (phase_mega).
    model = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.bfloat16, device=dev, bias_std=0.1)
    torch.cuda.synchronize()
    bf16_bytes = quantized_bytes(model)
    print(f"[S] large-v3, {bf16_bytes / 1e9:.3f} GB of bf16 weights, random "
          f"init {time.perf_counter() - t0:.2f} s", flush=True)
    mel = LogMelFeaturizer(n_mels=arch.n_mels, device=dev)(
        synth_audio(30, seed=3))
    mel10 = LogMelFeaturizer(n_mels=arch.n_mels, chunk_length_s=10,
                             device=dev)(synth_audio(10, seed=3))
    with torch.inference_mode():
        enc_bf16 = encoder_forward(model, mel)
    quantize_params(model, components=("decoder",))
    quantize_params(model, components=("encoder",), activation_int8=True)
    with torch.inference_mode():
        enc = encoder_forward(model, mel)
        enc10 = encoder_forward(model, mel10)
        diff = enc.float() - enc_bf16.float()
        rel = (diff.norm() / enc_bf16.float().norm()).item()
    check(bool(torch.isfinite(enc).all() and torch.isfinite(enc10).all())
          and enc10.shape[1] == 500,
          f"W8A8 encoder output not finite or 10 s shape {tuple(enc10.shape)}")
    print(f"[S] W8A8 encoder vs bf16 encoder, 30 s window: relative L2 err "
          f"{rel:.3e}, max abs err {diff.abs().max().item():.3e}", flush=True)
    del enc_bf16, diff
    engine = WhisperEngine(model, cross_kv_int8=True)
    check(model.mega is not None, "the S engine did not pack K3's operands")
    print(f"[S] quantized_bytes {quantized_bytes(model) / 1e9:.3f} GB "
          f"(bf16 {bf16_bytes / 1e9:.3f} GB)", flush=True)
    pipe = ASRPipeline(engine, chunk_length_s=30)
    results = []
    generate = engine._generate

    def recording(*args, **kwargs):
        res = generate(*args, **kwargs)
        results.append(res)
        return res

    engine._generate = recording
    # Made before the counts are zeroed, as a server makes them: the
    # batch-1 call then replays its CUDA graph without capturing.
    engine.warmup(3000, (1,), GEN_KW["max_new_tokens"], True)
    results.clear()
    batch = [synth_audio(s, seed=20 + i) for i, s in enumerate((4, 9, 17, 30))]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        wav20 = Path(tmp) / "speech20.wav"
        write_wav(wav20, synth_audio(20, seed=6))
        logmel.LOGMEL_LAUNCHES = attn.ATTN_LAUNCHES = mega.MEGA_LAUNCHES = 0
        r20 = timed("20 s WAV, word timestamps, batch 1", lambda: pipe(
            str(wav20), return_timestamps="word",
            generate_kwargs=dict(GEN_KW)), tag="S")
        k3_batch1 = mega.MEGA_LAUNCHES
        rb = timed("transcribe_batch of 4 (4, 9, 17, 30 s)",
                   lambda: pipe.transcribe_batch(
                       batch, return_timestamps="word",
                       generate_kwargs=dict(GEN_KW)), tag="S")
        launches = {"logmel": logmel.LOGMEL_LAUNCHES,
                    "encoder_attention": attn.ATTN_LAUNCHES,
                    "mega_step": mega.MEGA_LAUNCHES}
    engine._generate = generate
    print(f"[S] kernel launches on the S path: {launches}", flush=True)
    check([r.tokens.shape[0] for r in results] == [1, 4],
          f"engine calls {[r.tokens.shape for r in results]}")
    # One K3 launch a step call of the loop (replayed from its graph).
    steps = results[0].decode_steps
    check(steps > 0 and k3_batch1 == steps,
          f"K3 launches {k3_batch1} != {steps} step calls of the bs=1 call")
    check(launches["mega_step"] == k3_batch1, "K3 launched at batch 4")
    check(launches["logmel"] == 2, f"K1 launches {launches['logmel']} != 2")
    check(launches["encoder_attention"] == 2 * arch.encoder_layers,
          f"K2 launches {launches['encoder_attention']} != 2 x 32")
    check_word_chunks(r20, 20.0, ordered=True)
    check(len(rb) == 4, "transcribe_batch rows")
    for r, a in zip(rb, batch):
        check_word_chunks(r, len(a) / SAMPLE_RATE, ordered=True)
    for res in results:
        check(bool(np.isfinite(res.token_logprobs).all()
                   and np.isfinite(res.sum_logprob).all()
                   and np.isfinite(res.align).all()), "S result not finite")
    print(f"[S] 20 s: {len(r20['chunks'])} words, {steps} K3 steps; batch: "
          f"{[len(r['chunks']) for r in rb]} words", flush=True)
    return model, {30: enc, 10: enc10}, k3_batch1


def first_row_ratio(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Layer 0's fresh k (or v) row, kernel against plain, as a share of its
    bound (at most 1 passes): |got - ref| <= 2**-7 max(|got|, |ref|) +
    2**-10 max|ref|. Both sides take the same LN1 and the same int8 product
    of the same token, so they are one bf16 rounding of the output apart
    (2**-7 of the value bounds one bf16 step), plus the few LN1 outputs that
    may round the other way; each of those moves a value by one int8 weight
    times one bf16 step of an activation, far below 2**-10 of the row's
    largest value."""
    g, r = got.float(), ref.float()
    bound = 2 ** -7 * torch.maximum(g.abs(), r.abs()) + 2 ** -10 * r.abs().max()
    return ((g - r).abs() / bound).max().item()


# K3's cases: (decoder layers, cache length, positions, window in s). Cache
# lengths are the prompt's 4 plus max_new 1, 64 and 224; the last position
# is S - 1. A 30 s window gives T = 1500 cross positions; a 10 s window (a
# streaming tick's) T = 500, at turbo's depth and at large-v3's.
K3_CASES = ((32, 5, (4,), 30), (32, 68, (4, 40, 67), 30),
            (32, 228, (4, 150, 227), 30), (4, 68, (4, 67), 30),
            (1, 68, (4, 11, 20, 33, 40, 52, 60, 67), 30),
            (4, 68, (4, 40, 67), 10), (32, 68, (4, 40, 67), 10))
# Kernel and plain step round at the same points, but their f32 sums run
# in another order, so now and then one value rounds to the other bf16
# neighbour, and that difference spreads through every later rounding. On
# one layer such a cascade reaches a few 1e-3 (every step within
# K3_ONE_LAYER_REL) and a step in which nothing rounds the other way agrees
# to f32 noise (about 2e-7): among L = 1's eight steps the best must agree
# to K3_EXACT, since a fault (a dropped bias, a misread LayerNorm vector)
# moves every step. At depth both versions drift from the exact function by
# their own cascades, so each is measured against the same function with
# every rounding point in f32 (``mega.mega_reference``): the kernel's
# relative L2 distance from it may be at most F32_RATIO times the bf16
# plain version's, for the logits, the alignment and every layer's fresh
# k/v row.
K3_ONE_LAYER_REL = 1e-2
K3_EXACT = 1e-5
F32_RATIO = 1.5
PHASES = ("LN1 + qkv", "self-attention", "out-projection", "LN + cross q",
          "cross-attention", "cross out-proj", "LN2 + fc1 + GELU", "fc2")


def _layers(mp, ck, cv, depth):
    """K3's operands and the cross K/V of the first ``depth`` layers."""
    return (mp._replace(**{f: getattr(mp, f)[:depth] for f in (
        "qkv_w", "o_w", "cq_w", "co_w", "fc1_w", "fc2_w", "smalls")}),
        *(QuantizedKV(kv.q[:depth], kv.s[:depth]) for kv in (ck, cv)))


def l2_rel(got: torch.Tensor, ref: torch.Tensor,
           by_layer: bool = False) -> torch.Tensor:
    """||got - ref|| / ||ref|| in f32, over everything or, ``by_layer``,
    over each slice along dim 0."""
    g, r = got.float(), ref.float()
    if not by_layer:
        return (g - r).norm() / r.norm()
    return (g - r).flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)


def f32_ratio(got, plain, ref, by_layer: bool = False) -> float:
    """The kernel's distance from the f32 reference over the bf16 plain
    version's (the worst layer, ``by_layer``)."""
    return (l2_rel(got, ref, by_layer) / l2_rel(plain, ref, by_layer)).max().item()


def stamp_table(tag: str, stamps: torch.Tensor, n_layers: int,
                names=PHASES, final: bool = True) -> dict:
    """Prints where one launch's time went, from the kernel's phase stamps
    (``mega.stamps_tensor``, ``mlp.stamps_tensor``): for each phase of a
    layer (``names``), the mean over the layers of its work (start to
    arrival at its grid barrier), of that the matrix product, of that the
    wait for ring stages and warp 0's product loops, and its barrier wait
    (arrival to leaving), for block 0, and work and barrier wait for the
    last block; with ``final``, the final phase after the layers (K3/K4's
    LN and logits; a launch without it has no barrier after its last
    phase); and an upper bound on one barrier's own cost, the later leaving
    of the two blocks minus their later arrival (median and least over the
    barriers). Returns the totals and each phase's means for block 0."""
    s = stamps.cpu().double() / 1e3                        # us
    n = len(names)
    main = s[:, :n * n_layers].reshape(2, n_layers, n, -1)
    work = (main[..., 1] - main[..., 0]).mean(1)            # (2, n)
    wait = (main[..., 2] - main[..., 1]).mean(1)
    gemm = torch.where(main[..., 3] > 0, main[..., 1] - main[..., 3],
                       torch.zeros_like(main[..., 3])).mean(1)
    ring = main[..., 4].mean(1)
    mma = main[..., 5].mean(1)
    own = (main[..., 2].min(0).values - main[..., 1].max(0).values).flatten()
    if not final:
        own = own[:-1]                     # the last phase ends no barrier
    total = (s[0, -1, 2] - s[0, 0, 0]).item()
    print(f"[{tag}] phase stamps, us a layer (mean of {n_layers}); block 0: work "
          f"(of it the product, of that the ring wait and the product's loops), "
          f"barrier wait | last block: work, barrier wait", flush=True)
    for i, name in enumerate(names):
        print(f"[{tag}]   {i + 1}. {name:<17} {work[0, i]:7.3f} ({gemm[0, i]:6.3f}, "
              f"{ring[0, i]:6.3f}, {mma[0, i]:6.3f}) {wait[0, i]:7.3f} | {work[1, i]:7.3f} "
              f"{wait[1, i]:7.3f}", flush=True)
    layer = (work[0].sum() + wait[0].sum()).item()
    tail = ""
    final_us = None
    if final:
        final_us = (s[0, -1, 1] - s[0, -1, 0]).item()
        tail = (f"final LN + logits {final_us:.3f} us (ring wait "
                f"{s[0, -1, 4].item():.3f}); ")
    print(f"[{tag}]   a layer {layer:.3f} us (work {work[0].sum().item():.3f}, "
          f"of it products {gemm[0].sum().item():.3f} and ring waits "
          f"{ring[0].sum().item():.3f}; barrier wait {wait[0].sum().item():.3f}); "
          f"{tail}launch start to end {total:.3f} us; {own.numel()} grid barriers, "
          f"one at most {own.median().item():.3f} us (median; least "
          f"{own.min().item():.3f})", flush=True)
    phases = {name: {"work_us": work[0, i].item(), "product_us": gemm[0, i].item(),
                     "ring_wait_us": ring[0, i].item(), "loops_us": mma[0, i].item(),
                     "barrier_wait_us": wait[0, i].item()}
              for i, name in enumerate(names)}
    return {"layer_us": layer, "wait_us": wait[0].sum().item(),
            "final_us": final_us, "total_us": total, "phases": phases}


def phase_mega(model, encs) -> dict:
    """K3 against its plain version on the S model's packed operands
    (random biases and LayerNorm parameters), the cross K/V of a 30 s or a
    10 s window through the W8A8 encoder with K2 (``encs``, by window) and
    random bf16 self K/V, on the first L layers for each of ``K3_CASES``.
    Checks: the f32-referenced
    bound (``F32_RATIO``) on the logits, the alignment and every layer's
    fresh k/v row; at L = 1 ``K3_ONE_LAYER_REL`` and ``K3_EXACT`` for the
    best step; layer 0's fresh k/v row to ``first_row_ratio``; every other
    cache slot bit-identical (only slot pos is written). Times kernel
    (eager and from a CUDA graph) and plain step for each depth and cache
    length, and prints the phase stamps of one L = 32, S = 68 step."""
    arch, mp = model.arch, model.mega
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(7)
    main = None
    with torch.inference_mode():
        cross = {w: tuple(map(quantize_kv, compute_cross_kv(model, enc)))
                 for w, enc in encs.items()}
        for depth, s_len, positions, window in K3_CASES:
            arch_l = dataclasses.replace(arch, decoder_layers=depth)
            mp_l, ck_l, cv_l = _layers(mp, *cross[window], depth)
            base = make_cache(arch_l, 1, s_len, ck_l, cv_l,
                              dtype=torch.bfloat16)
            for t in (base.self_k, base.self_v):
                t.copy_(0.5 * torch.randn(t.shape, generator=g, device=dev))
            where = f"L={depth} S={s_len} T={ck_l.q.shape[-2]}"
            rels = []
            for pos in positions:
                x = embed_tokens(model, torch.tensor([[100 + pos]], device=dev),
                                 pos)[:, 0]
                caches = [DecodeCache(base.self_k.clone(), base.self_v.clone(),
                                      ck_l, cv_l) for _ in range(2)]
                lk, ak = mega.mega_step(mp_l, x, pos, caches[0], arch_l)
                lp, ap = mega.mega_step_plain(mp_l, x, pos, caches[1], arch_l)
                lr, ar, ref = mega.mega_reference(mp_l, x, pos, base, arch_l)
                torch.cuda.synchronize()
                err = (lk - lp).abs().max().item()
                rel = err / lp.abs().max().item()
                rels.append(rel)
                rows = [(k[:, 0, :, pos], p[:, 0, :, pos], r[:, 0, :, pos])
                        for k, p, r in zip(caches[0][:2], caches[1][:2], ref[:2])]
                ratios = {"logits": f32_ratio(lk, lp, lr),
                          "k/v rows": max(f32_ratio(k, p, r, by_layer=True)
                                          for k, p, r in rows)}
                if ap.abs().max() > 0:
                    ratios["align"] = f32_ratio(ak, ap, ar[0])
                ratio0 = max(first_row_ratio(k[0], p[0]) for k, p, _ in rows)
                keep = torch.arange(s_len, device=dev) != pos
                same = all(torch.equal(got[:, :, :, keep], ref_[:, :, :, keep])
                           for c in caches for got, ref_ in zip(c[:2], base[:2]))
                print(f"[K3] {where:>18} pos={pos:>3d}: logits max abs err "
                      f"{err:.3e} (rel {rel:.3e}); distance from f32 over the "
                      f"plain version's: "
                      f"{', '.join(f'{k} {v:.3f}' for k, v in ratios.items())};"
                      f" layer 0 k/v row {ratio0:.3f} of its bound, other "
                      f"slots identical {same}", flush=True)
                check(max(ratios.values()) <= F32_RATIO,
                      f"K3 f32-referenced ratios {ratios} at {where} pos={pos}")
                check(ratio0 <= 1.0, f"K3 layer 0 k/v row {ratio0} of its "
                      f"bound at {where} pos={pos}")
                check(same, f"K3 touched a cache slot other than {pos}")
                check(bool(torch.isfinite(lk).all()), "K3 logits not finite")
            if depth == 1:
                check(max(rels) <= K3_ONE_LAYER_REL and min(rels) <= K3_EXACT,
                      f"K3 at {where}: steps {rels} (every one within "
                      f"{K3_ONE_LAYER_REL}, the best within {K3_EXACT})")
            ms = cuda_ms(lambda: mega.mega_step(mp_l, x, pos, caches[0], arch_l))
            dev_ms = graph_ms(lambda: mega.mega_step(mp_l, x, pos, caches[0],
                                                     arch_l))
            plain_ms = cuda_ms(
                lambda: mega.mega_step_plain(mp_l, x, pos, caches[1], arch_l),
                iters=5)
            print(f"[K3] {where:>18}: kernel {ms:.4f} ms eager, {dev_ms:.4f} ms "
                  f"on the device (CUDA graph)  plain {plain_ms:.4f} ms per step",
                  flush=True)
            if (depth, s_len, window) == (32, 68, 30):  # the main path's step
                stamps = mega.stamps_tensor(depth, dev)
                mega.mega_step(mp_l, x, pos, caches[0], arch_l, stamps=stamps)
                torch.cuda.synchronize()
                stamp_table("K3 L=32 S=68", stamps, depth)
                # The decode loop's route: the slot read from device memory,
                # the self-attention planned for the whole cache.
                slot = torch.tensor([pos], dtype=torch.int32, device=dev)
                copies = [DecodeCache(base.self_k.clone(), base.self_v.clone(),
                                      ck_l, cv_l) for _ in range(2)]
                lh, _ = mega.mega_step(mp_l, x, pos, copies[0], arch_l)
                ld, _ = mega.mega_step(mp_l, x, slot, copies[1], arch_l)
                check(torch.equal(lh, ld) and torch.equal(copies[0].self_k,
                                                          copies[1].self_k),
                      "K3 with a device slot differs from K3 at the host int")
                route = lambda: mega.mega_step(  # noqa: E731
                    mp_l, x, slot, caches[0], arch_l, check=False)
                ms_dev, graph_dev = cuda_ms(route), graph_ms(route)
                mega.raise_position_errors(dev)
                print(f"[K3] {where:>18}: device slot pos={pos}, planned for "
                      f"{s_len} slots: {ms_dev:.4f} ms eager, {graph_dev:.4f} "
                      f"ms on the device (CUDA graph); equal to the host int's "
                      f"bits", flush=True)
                main = {"max_abs_err": err, "ms": ms_dev, "graph_ms": graph_dev,
                        "host_int_ms": ms, "host_int_graph_ms": dev_ms,
                        "plain_ms": plain_ms,
                        **step_bound(mp_l, ck_l, cv_l, caches[0], pos, 1),
                        "library_ms": None}
        main.update(k3_long_cache(model, mp, cross[30], g))
    print(f"[K3] bound at L=32 S=68 {main['bound_ms']:.4f} ms ({main['bound_by']}); "
          f"eager {main['ms'] / main['bound_ms']:.2f}x, device "
          f"{main['graph_ms'] / main['bound_ms']:.2f}x of it", flush=True)
    return main


def k3_long_cache(model, mp, cross, g) -> dict:
    """K3 at L = 32 on a 448-slot cache (``max_target_positions``), T = 1500:
    the slot read from device memory with the self-attention planned for
    all 448 slots (as a captured step plans it) against the host int
    planned for pos + 1, at pos 10 and 400; eager and from a CUDA graph,
    equal bits."""
    arch, dev = model.arch, model.device
    base = make_cache(arch, 1, 448, *cross, dtype=torch.bfloat16)
    for t in (base.self_k, base.self_v):
        t.copy_(0.5 * torch.randn(t.shape, generator=g, device=dev))
    out = {}
    for pos in (10, 400):
        x = embed_tokens(model, torch.tensor([[100 + pos]], device=dev),
                         pos)[:, 0]
        slot = torch.tensor([pos], dtype=torch.int32, device=dev)
        caches = [DecodeCache(base.self_k.clone(), base.self_v.clone(),
                              *cross) for _ in range(2)]
        lh, _ = mega.mega_step(mp, x, pos, caches[0], arch)
        ld, _ = mega.mega_step(mp, x, slot, caches[1], arch)
        check(torch.equal(lh, ld), f"K3 at S=448 pos={pos}: device slot "
              "and host int differ")
        times = {}
        for name, fn in (("host", lambda: mega.mega_step(
                mp, x, pos, caches[0], arch)), ("device", lambda: mega.mega_step(
                mp, x, slot, caches[1], arch, check=False))):
            times[name] = (cuda_ms(fn), graph_ms(fn))
        mega.raise_position_errors(dev)
        print(f"[K3] L=32 S=448 pos={pos}: device slot planned for 448 slots "
              f"{times['device'][0]:.4f} ms eager, {times['device'][1]:.4f} "
              f"on the device; host int planned for {pos + 1} "
              f"{times['host'][0]:.4f} / {times['host'][1]:.4f}", flush=True)
        out[f"s448_pos{pos}_ms"] = times["device"][0]
        out[f"s448_pos{pos}_graph_ms"] = times["device"][1]
        out[f"s448_pos{pos}_host_int_ms"] = times["host"][0]
    return out


def step_bound(mp, ck, cv, cache, pos: int, rows: int) -> dict:
    """K3's (rows = 1) or K4's bound: every packed operand and the int8
    cross K/V read once, the self K/V of slots 0 .. pos + rows - 1 read, the
    window's logits written; two operations a weight byte for each row
    (about 2 GFLOP a row at large-v3), at the bf16 rate."""
    n_layers, _, n_heads, _, dh = cache.self_k.shape
    self_kv = 2 * n_layers * n_heads * (pos + rows) * dh * 2
    weights = nbytes(mp.qkv_w, mp.o_w, mp.cq_w, mp.co_w, mp.fc1_w, mp.fc2_w,
                     mp.emb_q)
    moved = (nbytes(*mp) + nbytes(ck.q, cv.q, ck.s, cv.s) + self_kv
             + rows * mp.emb_s.numel() * 4)
    return bound(moved, 2 * rows * weights, BF16_FLOPS)


# K4's cases: (decoder layers, cache length, window, positions). The cache
# lengths are a speculative call's: prompt 4 + max_new 64 + W + 1 for
# W = 4 (a window of 5 rows) and W = 15 (16 rows); the last position is
# S - W.
K4_CASES = ((32, 73, 5, (4, 40, 68)), (32, 84, 16, (4, 68)),
            (32, 73, 1, (40,)), (4, 73, 5, (4, 68)),
            (1, 73, 5, (4, 11, 20, 29, 37, 46, 55, 68)))


def phase_verify(model, enc) -> dict:
    """K4 against its plain version on the S model's packed operands, the
    cross K/V of a 30 s window through the W8A8 encoder with K2 and random
    bf16 self K/V, for each of ``K4_CASES``. K4 is K3 over W rows at the
    same rounding points, so K3's checks hold row by row: the
    f32-referenced bound on the logits and every layer's window k/v rows;
    at L = 1 every row within ``K3_ONE_LAYER_REL`` and the best row of the
    eight windows within ``K3_EXACT`` (a window's worst row agrees to f32
    noise only when none of its rows has a value that rounds the other
    way); layer 0's window rows to ``first_row_ratio``; every slot outside
    the window bit-identical. Then one L = 1 window against K3 stepping its
    tokens (row j against step j, K3's L = 1 bounds), the times of K4 (eager
    and from a CUDA graph), the plain verify and K3 at L = 32, and the phase
    stamps of one L = 32 window of 5."""
    arch, mp = model.arch, model.mega
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(8)
    main, times = None, {}
    with torch.inference_mode():
        ck, cv = (quantize_kv(t) for t in compute_cross_kv(model, enc))
        for depth, s_len, w, positions in K4_CASES:
            arch_l = dataclasses.replace(arch, decoder_layers=depth)
            mp_l, ck_l, cv_l = _layers(mp, ck, cv, depth)
            base = make_cache(arch_l, 1, s_len, ck_l, cv_l,
                              dtype=torch.bfloat16)
            for t in (base.self_k, base.self_v):
                t.copy_(0.5 * torch.randn(t.shape, generator=g, device=dev))
            where = f"L={depth} S={s_len} W={w}"
            rels = []
            for pos in positions:
                tokens = torch.arange(100 + pos, 100 + pos + w, device=dev)
                x = embed_tokens(model, tokens[None], pos)[0]
                caches = [DecodeCache(base.self_k.clone(), base.self_v.clone(),
                                      ck_l, cv_l) for _ in range(2)]
                lk = mega.mega_verify(mp_l, x, pos, caches[0], arch_l)
                lp = mega.mega_verify_plain(mp_l, x, pos, caches[1], arch_l)
                lr, _, ref = mega.mega_reference(mp_l, x, pos, base, arch_l)
                torch.cuda.synchronize()
                err = (lk - lp).abs().max().item()
                rel = err / lp.abs().max().item()
                row_rels = ((lk - lp).abs().amax(1) / lp.abs().amax(1)).tolist()
                rels.extend(row_rels)
                win = slice(pos, pos + w)
                rows = [(k[:, 0, :, win], p[:, 0, :, win], r[:, 0, :, win])
                        for k, p, r in zip(caches[0][:2], caches[1][:2], ref[:2])]
                ratios = {"logits": f32_ratio(lk, lp, lr),
                          "k/v rows": max(f32_ratio(k, p, r, by_layer=True)
                                          for k, p, r in rows)}
                ratio0 = max(first_row_ratio(k[0], p[0]) for k, p, _ in rows)
                keep = torch.ones(s_len, dtype=torch.bool, device=dev)
                keep[win] = False
                same = all(torch.equal(got[:, :, :, keep], ref_[:, :, :, keep])
                           for c in caches for got, ref_ in zip(c[:2], base[:2]))
                print(f"[K4] {where:>16} pos={pos:>3d}: logits max abs err "
                      f"{err:.3e} (rel {rel:.3e}; best row "
                      f"{min(row_rels):.3e}); distance from f32 over the plain "
                      f"version's: "
                      f"{', '.join(f'{k} {v:.3f}' for k, v in ratios.items())};"
                      f" layer 0 window k/v {ratio0:.3f} of its bound, other "
                      f"slots identical {same}", flush=True)
                check(max(ratios.values()) <= F32_RATIO,
                      f"K4 f32-referenced ratios {ratios} at {where} pos={pos}")
                check(ratio0 <= 1.0, f"K4 layer 0 window k/v {ratio0} of its "
                      f"bound at {where} pos={pos}")
                check(same, f"K4 touched a cache slot outside {pos}..{pos + w - 1}")
                check(bool(torch.isfinite(lk).all()), "K4 logits not finite")
            if depth == 1:
                check(max(rels) <= K3_ONE_LAYER_REL and min(rels) <= K3_EXACT,
                      f"K4 at {where}: rows {rels} (every one within "
                      f"{K3_ONE_LAYER_REL}, the best within {K3_EXACT})")
            if depth == 32:
                ms = cuda_ms(lambda: mega.mega_verify(mp_l, x, pos, caches[0],
                                                      arch_l))
                dev_ms = graph_ms(lambda: mega.mega_verify(
                    mp_l, x, pos, caches[0], arch_l))
                plain_ms = cuda_ms(lambda: mega.mega_verify_plain(
                    mp_l, x, pos, caches[1], arch_l), iters=5)
                times[w] = (ms, dev_ms, plain_ms)
                if w == 5:                       # the main path's window
                    stamps = mega.stamps_tensor(depth, dev)
                    mega.mega_verify(mp_l, x, pos, caches[0], arch_l,
                                     stamps=stamps)
                    torch.cuda.synchronize()
                    stamp_table("K4 L=32 W=5", stamps, depth)
                    main = {"max_abs_err": err, "ms": ms, "graph_ms": dev_ms,
                            "plain_ms": plain_ms,
                            **step_bound(mp_l, ck_l, cv_l, caches[0], pos, w),
                            "library_ms": None}

        # One L = 1 window against K3 stepping the same tokens.
        mp_1, ck_1, cv_1 = _layers(mp, ck, cv, 1)
        arch_1 = dataclasses.replace(arch, decoder_layers=1)
        base = make_cache(arch_1, 1, 73, ck_1, cv_1, dtype=torch.bfloat16)
        for t in (base.self_k, base.self_v):
            t.copy_(0.5 * torch.randn(t.shape, generator=g, device=dev))
        pos, w = 30, 5
        x = embed_tokens(model, torch.arange(300, 300 + w, device=dev)[None],
                         pos)[0]
        lv = mega.mega_verify(mp_1, x, pos, DecodeCache(
            base.self_k.clone(), base.self_v.clone(), ck_1, cv_1), arch_1)
        steps = DecodeCache(base.self_k.clone(), base.self_v.clone(), ck_1, cv_1)
        rels = []
        for j in range(w):
            ls, _ = mega.mega_step(mp_1, x[j:j + 1], pos + j, steps, arch_1,
                                   capture_align=False)
            rels.append(((lv[j] - ls[0]).abs().max() / ls.abs().max()).item())
        torch.cuda.synchronize()
        print(f"[K4] L=1 window of {w} against K3 stepping it: logits rel err "
              f"by row {', '.join(f'{r:.3e}' for r in rels)}", flush=True)
        check(max(rels) <= K3_ONE_LAYER_REL and min(rels) <= K3_EXACT,
              f"K4 rows against K3 steps: {rels}")

        # K3's step at the same depth and cache length, for the ratio.
        mp_l, ck_l, cv_l = _layers(mp, ck, cv, 32)
        step_cache = make_cache(arch, 1, 73, ck_l, cv_l, dtype=torch.bfloat16)
        x1 = embed_tokens(model, torch.tensor([[140]], device=dev), 40)[:, 0]
        k3_ms = cuda_ms(lambda: mega.mega_step(mp_l, x1, 40, step_cache, arch))
        k3_dev = graph_ms(lambda: mega.mega_step(mp_l, x1, 40, step_cache, arch))
    for w, (ms, dev_ms, plain_ms) in sorted(times.items()):
        print(f"[K4] L=32 window {w:>2d}: kernel {ms:.4f} ms eager, {dev_ms:.4f}"
              f" ms on the device (CUDA graph)  plain {plain_ms:.4f} ms a round; "
              f"K3 {k3_ms:.4f} ms eager, {k3_dev:.4f} ms on the device a step; "
              f"one K4 round / one K3 step {ms / k3_ms:.3f} eager, "
              f"{dev_ms / k3_dev:.3f} on the device", flush=True)
    print(f"[K4] bound at L=32 W=5 {main['bound_ms']:.4f} ms ({main['bound_by']}); "
          f"eager {main['ms'] / main['bound_ms']:.2f}x, device "
          f"{main['graph_ms'] / main['bound_ms']:.2f}x of it", flush=True)
    return main


def spec_call(name: str, engine: WhisperEngine, wav: Path, results: dict,
              launches: dict, walls: dict) -> None:
    """One ``ASRPipeline`` call of ``engine`` on ``wav`` (batch 1, no
    timestamps) with the launch counts zeroed just before it: its result,
    launches and wall under ``name``."""
    generate = engine._generate
    engine._generate = lambda *a, _g=generate, **k: (
        results.setdefault(name, _g(*a, **k)))
    pipe = ASRPipeline(engine, chunk_length_s=30)
    logmel.LOGMEL_LAUNCHES = attn.ATTN_LAUNCHES = 0
    mega.MEGA_LAUNCHES = mega.MEGA_VERIFY_LAUNCHES = 0
    t0 = time.perf_counter()
    out = timed(f"{name}: 20 s WAV, batch 1, no timestamps", lambda: pipe(
        str(wav), generate_kwargs=dict(GEN_KW)), tag="SPEC")
    walls[name] = time.perf_counter() - t0
    launches[name] = {"logmel": logmel.LOGMEL_LAUNCHES,
                      "encoder_attention": attn.ATTN_LAUNCHES,
                      "mega_step": mega.MEGA_LAUNCHES,
                      "mega_verify": mega.MEGA_VERIFY_LAUNCHES}
    engine._generate = generate
    check(out["text"].strip() != "", f"{name}: empty transcript")


def phase_spec(model, smi: str):
    """The speculative S path: an ngram engine and a two-layer layer-skip
    engine on the S model, each with CUDA graphs (warmed first, so that
    its call replays without capturing) and with ``cuda_graphs=False``,
    and the K3 greedy engine, on one 20 s WAV at batch 1 without
    timestamps. Each draft's graph and eager calls must give the same
    result, bit for bit, and K4 must launch once a verify round (from the
    graph's replays, or eagerly), K3 never. Returns K4's launches on the
    graph engine's ngram call."""
    def spec_engine(draft: str, graphs: bool) -> WhisperEngine:
        kw = ({"spec_ngram": True} if draft == "ngram" else
              {"draft_model": make_layer_skip_draft(model, 2)})
        return WhisperEngine(model, cross_kv_int8=True, cuda_graphs=graphs,
                             **kw)

    engines = {"greedy": WhisperEngine(model, cross_kv_int8=True)}
    for draft in ("ngram", "layer-skip:2"):
        engines[f"{draft} graph"] = spec_engine(draft, True)
        engines[f"{draft} eager"] = spec_engine(draft, False)
    for name, engine in engines.items():
        if engine.cuda_graphs:
            engine.warmup(3000, (1,), GEN_KW["max_new_tokens"], False)
    results, launches, walls = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        wav20 = Path(tmp) / "speech20.wav"
        write_wav(wav20, synth_audio(20, seed=6))
        for name, engine in engines.items():
            spec_call(name, engine, wav20, results, launches, walls)
    ref = results["greedy"]
    p, n_ref = ref.prompt_len, int(ref.num_generated[0])
    for name, res in results.items():
        n = int(res.num_generated[0])
        check(bool(np.isfinite(res.token_logprobs).all()
                   and np.isfinite(res.sum_logprob).all()),
              f"{name}: logprobs not finite")
        shared = 0
        while (shared < min(n, n_ref)
               and res.tokens[0, p + shared] == ref.tokens[0, p + shared]):
            shared += 1
        rounds = res.spec_rounds
        per_round = f", {(n - 1) / rounds:.3f} tokens a round after the " \
            f"prefill's first ({rounds} rounds)" if rounds else ""
        print(f"[SPEC] {name}: {n} tokens{per_round}; call wall "
              f"{walls[name]:.3f} s; kernel launches {launches[name]}; "
              f"{shared} leading tokens shared with greedy's {n_ref}",
              flush=True)
    for draft in ("ngram", "layer-skip:2"):
        g, e = results[f"{draft} graph"], results[f"{draft} eager"]
        for field in ("tokens", "num_generated", "sum_logprob",
                      "token_logprobs", "no_speech_prob"):
            check(np.array_equal(getattr(g, field), getattr(e, field)),
                  f"{draft}: graph and eager {field} differ")
        check(g.spec_rounds == e.spec_rounds,
              f"{draft}: rounds {g.spec_rounds} (graph) != {e.spec_rounds}")
        for name in (f"{draft} graph", f"{draft} eager"):
            rounds = results[name].spec_rounds
            check(rounds is not None and rounds > 0, f"{name}: no verify round")
            check(launches[name]["mega_verify"] == rounds,
                  f"{name}: K4 launches {launches[name]['mega_verify']} != "
                  f"{rounds} verify rounds")
            check(launches[name]["mega_step"] == 0, f"{name}: K3 launched")
            check(launches[name]["logmel"] == 1
                  and launches[name]["encoder_attention"]
                  == model.arch.encoder_layers,
                  f"{name}: K1/K2 launches {launches[name]}")
        (prog,) = [q for q in engines[f"{draft} graph"].programs()
                   if len(q["key"]) > 6]
        check(prog["graph"], f"{draft}: no graph captured")
        print(f"[SPEC] {draft}: graph == eager (tokens, num_generated, "
              f"sum_logprob, token_logprobs, no_speech_prob), {g.spec_rounds} "
              f"rounds each, K4 launches == rounds; call wall "
              f"{walls[draft + ' graph']:.3f} s from the graph, "
              f"{walls[draft + ' eager']:.3f} s eager; program {prog['key']}: "
              f"capture and buffers {prog['seconds']:.3f} s, "
              f"{prog['bytes'] / 2 ** 20:.1f} MiB; {smi}", flush=True)
    return launches["ngram graph"]["mega_verify"]


# Q4 is timed at these row counts: the decode step at batch 1, 4 and 32,
# 160 (32 x 5 beams), and a 30 s window's cross K/V (1500 encoder
# positions); and the cross K/V's own shape (1280 x 1280, two linears a
# layer) at a batch of four windows.
Q4_ROWS = (1, 4, 32, 160, 1500)
Q4_CROSS_KV_ROWS = 6000


def s4_linears(model) -> list:
    """Each decoder layer's six S4 linears in the step's order: fused qkv,
    self out, cross q, cross out, fc1, fc2."""
    return [[l.self_attn.qkv, l.self_attn.out, l.cross_attn.q,
             l.cross_attn.out, l.fc1, l.fc2] for l in model.decoder.layers]


def step_ms(model, batch: int, **kw) -> tuple:
    """(host ms a step, device ms a step) of the greedy loop from its CUDA
    graph at ``batch`` x 30 s, 64 new tokens, word timestamps, on a
    warmed ``WhisperEngine(model, cross_kv_int8=True, **kw)``
    (``loop_ms``, ``replay_ms``)."""
    engine = WhisperEngine(model, cross_kv_int8=True, **kw)
    engine.warmup(3000, (batch,), 64, True)
    feat = LogMelFeaturizer(n_mels=model.arch.n_mels, device=model.device)
    engine.transcribe_features(
        feat([synth_audio(30, seed=90 + i) for i in range(batch)]),
        GenerationOptions(language="en", max_new_tokens=64,
                          return_timestamps=True))
    (key,) = [p["key"] for p in engine.programs()]
    return loop_ms(engine, key)[0], replay_ms(engine, key)


def s4_small_reference() -> None:
    """A small f32 S4 model (``phase_small_reference``'s arch, its decoder
    int4, int8 cross K/V) decodes the same tokens on the card (Q4's f32
    route) as on the CPU (the plain version), greedy and speculating with
    a one-layer layer-skip draft (int4 layers too)."""
    arch = dataclasses.replace(
        ARCH_PRESETS["large-v3-turbo"], d_model=256, encoder_layers=2,
        encoder_heads=4, decoder_layers=2, decoder_heads=4, d_ff=1024,
        alignment_heads=((1, 0), (1, 2)))
    cpu_model = init_params(arch, torch.Generator().manual_seed(1))
    quantize_params(cpu_model, components=("decoder",), bits=4)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    padded = np.zeros((1, 30 * SAMPLE_RATE), np.float32)
    audio = synth_audio(20, seed=5)
    padded[0, :len(audio)] = audio
    opts = GenerationOptions(language="en", max_new_tokens=32,
                             return_timestamps=True)
    res, launches = [], []
    for model in (cpu_model, gpu_model):
        q4.Q4_LAUNCHES = 0
        for engine in (WhisperEngine(model, cross_kv_int8=True),
                       WhisperEngine(model, cross_kv_int8=True, draft_model=
                                     make_layer_skip_draft(model, 1))):
            res.append(engine.transcribe_audio(padded, opts))
        launches.append(q4.Q4_LAUNCHES)
    check(launches[0] == 0 and launches[1] > 0,
          f"small S4 model: Q4 launches {launches} (CPU, card)")
    for r in res:
        check(np.array_equal(r.tokens, res[0].tokens)
              and np.array_equal(r.num_generated, res[0].num_generated),
              "small f32 S4 model: tokens differ between card, CPU, greedy "
              "and layer-skip")
        check(bool(np.isfinite(r.token_logprobs).all()),
              "small f32 S4 model: logprobs not finite")
    lp = np.abs(res[2].token_logprobs - res[0].token_logprobs).max()
    print(f"[S4] small f32 S4 model, 20 s: card (Q4, {launches[1]} launches) "
          f"== CPU (plain) tokens, greedy and layer-skip:1 "
          f"({int(res[0].num_generated[0])} generated; verify rounds "
          f"{res[1].spec_rounds} CPU, {res[3].spec_rounds} card); logprobs "
          f"card - CPU max abs {lp:.3e}", flush=True)


def q4_row(tag: str, mods: list, rows: int, g, smi: str) -> dict:
    """[Q4] at ``rows`` rows over ``mods`` (lists of S4 linears, one a
    layer, in one CUDA graph): device ms a layer with PDL where the plan
    launches with it and with none,
    beside the plain version's, ``F.linear``'s on dense bf16 weights of the
    same shapes (the yardstick; the port never calls it) and the library's
    int4 weight-only product ``torch._weight_int4pack_mm`` on the same
    weights (repacked once: group size 128, each row's scale repeated along
    K, zero points of 0; its bias added outside the timing for the check),
    and the bound (packed weights, scales, biases, x and y over 3.35 TB/s,
    or 2 M N K over the bf16 peak). Q4 and the library call are held
    against the plain version on the first layer (relative L2 below
    1e-2)."""
    dev = mods[0][0].weight.device
    n_layers = len(mods)
    xs = {m.in_features: torch.randn(rows, m.in_features, generator=g, device=dev,
                                     dtype=torch.bfloat16) for m in mods[0]}
    err, rel = 0.0, 0.0
    for mod in mods[0]:
        x = xs[mod.in_features]
        got = mod(x)
        ref = q4.int4_linear_plain(x, mod.weight, mod.scale, mod.bias)
        err = max(err, (got.float() - ref.float()).abs().max().item())
        rel = max(rel, l2_rel(got, ref).item())
    check(rel < 1e-2, f"Q4 {tag} at M = {rows}: relative L2 {rel:.3e} from plain")

    def every(fn):
        return lambda: [fn(mod, xs[mod.in_features]) for row in mods for mod in row]

    ms = graph_ms(every(lambda mod, x: mod(x)), calls=1, iters=3) / n_layers
    saved, q4.PDL = q4.PDL, False
    try:
        ms_no_pdl = graph_ms(every(lambda mod, x: mod(x)), calls=1, iters=3) / n_layers
    finally:
        q4.PDL = saved
    plain = graph_ms(every(lambda mod, x: q4.int4_linear_plain(
        x, mod.weight, mod.scale, mod.bias)), calls=1, iters=3) / n_layers
    dense = [[(q4.unpack_int4(m.weight).to(torch.bfloat16)
               * m.scale.to(torch.bfloat16)[:, None], m.bias) for m in row]
             for row in mods]
    yardstick = graph_ms(lambda: [torch.nn.functional.linear(xs[w.shape[1]], w, b)
                                  for row in dense for w, b in row],
                         calls=1, iters=3) / n_layers
    del dense
    library, lib_rel, lib_note = None, None, ""
    try:
        lib = [[q4_probe.library_weights(m.weight, m.scale) for m in row] for row in mods]
        lib_rel = max(l2_rel(q4_probe.library_mm(xs[m.in_features], w, sz)
                             + (0 if m.bias is None else m.bias),
                             q4.int4_linear_plain(xs[m.in_features], m.weight,
                                                  m.scale, m.bias)).item()
                      for m, (w, sz) in zip(mods[0], lib[0]))
        check(lib_rel < 1e-2, f"torch._weight_int4pack_mm at M = {rows}: relative "
                              f"L2 {lib_rel:.3e} from Q4's plain version")
        library = graph_ms(lambda: [q4_probe.library_mm(xs[m.in_features], w, sz)
                                    for row, lrow in zip(mods, lib)
                                    for m, (w, sz) in zip(row, lrow)],
                           calls=1, iters=3) / n_layers
        del lib
    except (RuntimeError, AttributeError, NotImplementedError) as exc:
        lib_note = f"{type(exc).__name__}: {str(exc)[:160]}"
    moved = sum(nbytes(m.weight, m.scale) + (0 if m.bias is None else nbytes(m.bias))
                + rows * (m.in_features + m.out_features) * 2 for m in mods[0])
    flops = sum(2 * rows * m.in_features * m.out_features for m in mods[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = [q4.plan(rows, m.out_features, m.in_features, sms) for m in mods[0]]
    out = {"max_abs_err": err, "l2_rel": rel, "ms": ms, "ms_no_pdl": ms_no_pdl,
           "plain_ms": plain, "dense_bf16_ms": yardstick, "library_ms": library,
           "library_l2_rel": lib_rel, "library_note": lib_note or None,
           "routes": sorted({f"{p.route} split {p.split}{' pdl' if p.pdl else ''}"
                             for p in plans}),
           **bound(moved, flops, BF16_FLOPS)}
    lib_text = (f"torch._weight_int4pack_mm {library:.4f} (relative L2 {lib_rel:.3e} "
                f"from plain)" if library is not None else
                f"torch._weight_int4pack_mm not timed ({lib_note})")
    print(f"[Q4] {tag} M = {rows}: {ms:.4f} ms a layer (graph, {n_layers} layers; "
          f"PDL where planned; {ms_no_pdl:.4f} with none), plain {plain:.4f}, "
          f"F.linear on dense bf16 "
          f"{yardstick:.4f}, {lib_text}; bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']} ({out['bound_ms'] / ms:.1%} of it); routes "
          f"{out['routes']}; layer 0 vs plain: max abs err {err:.3e}, relative "
          f"L2 {rel:.3e}; {smi}", flush=True)
    return out


def phase_q4(model, smi: str) -> dict:
    """[Q4] The kernel alone at large-v3's six decoder linears (qkv 3840 x
    1280; self out, cross q and cross out 1280 x 1280; fc1 5120 x 1280;
    fc2 1280 x 5120) for M in ``Q4_ROWS``, the S4 model's 32 layers, 192
    launches, in one CUDA graph (367 MB of packed weights, more than the
    L2 holds, as a step reads them), and at the cross K/V's own shape (its
    k and v linears, 64 launches) at ``Q4_CROSS_KV_ROWS`` (``q4_row``).
    Returns the kernels line's entry: M = 1, the decode step's rows, and
    every M under ``by_rows``."""
    layers = s4_linears(model)
    g = torch.Generator(device=model.device).manual_seed(7)
    by_rows = {str(rows): q4_row("six linears", layers, rows, g, smi)
               for rows in Q4_ROWS}
    kv = [[l.cross_attn.k, l.cross_attn.v] for l in model.decoder.layers]
    by_rows[f"cross K/V {Q4_CROSS_KV_ROWS}"] = q4_row(
        "cross K/V", kv, Q4_CROSS_KV_ROWS, g, smi)
    return {**by_rows["1"], "rows": 1, "by_rows": by_rows}


def phase_s4(model_s, smi: str):
    """[S4] The int4 "S4" path at large-v3 width, after [S] on the same
    weights: ``init_params`` from [S]'s seed, the decoder quantized with
    ``quantize_params(bits=4)`` (int4 linears, int8 table; the encoder
    bf16, with K2), ``WhisperEngine(cross_kv_int8=True)``. ``model.mega``
    stays None: no K3 or K4. ``ASRPipeline`` on the 20 s WAV at batch 1
    with word timestamps and ``transcribe_batch`` of four buffers, the
    engine warmed first; Q4 launches 6 x 32 a step from the graph, 6 x 32
    for the prefill and 2 x 32 for the cross K/V of each call. Graph against
    eager at batch 1 and 4 (``graph_vs_eager``); ms a step from the graph
    at batch 1 and 4 beside S's plain int8 step (``megakernel=False``) and
    S's K3 route at batch 1; quantized bytes; the small f32 S4 model on
    card and CPU; [Q4]. Returns (Q4's launches on the path, [Q4]'s
    entry, the S4 model)."""
    dev = model_s.device
    arch = model_s.arch
    n = arch.decoder_layers
    model = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.bfloat16, device=dev, bias_std=0.1)
    quantize_params(model, components=("decoder",), bits=4)
    engine = WhisperEngine(model, cross_kv_int8=True)
    kinds = {type(m) for m in model.decoder.modules()
             if "Linear" in type(m).__name__}
    check(model.mega is None and kinds == {Int4Linear},
          f"S4 decoder: mega {model.mega is not None}, linears {kinds}")
    print(f"[S4] quantized_bytes of the decoder: S4 "
          f"{quantized_bytes(model.decoder) / 1e9:.4f} GB, S "
          f"{quantized_bytes(model_s.decoder) / 1e9:.4f} GB; the model "
          f"{quantized_bytes(model) / 1e9:.4f} GB (bf16 encoder)", flush=True)
    pipe = ASRPipeline(engine, chunk_length_s=30)
    results = []
    generate = engine._generate
    engine._generate = lambda *a, **k: results.append(generate(*a, **k)) or results[-1]
    engine.warmup(3000, (1, 4), GEN_KW["max_new_tokens"], True)
    graphs = [p.graph for p in engine._programs.values()]
    check(len(graphs) == 2 and all(
        gr is not None and gr.q4_launches == 6 * n * STEPS_PER_CHECK
        and gr.launches == gr.verify_launches == 0 for gr in graphs),
        "S4: a step graph does not hold 6 x 32 Q4 launches a step")
    results.clear()
    batch = [synth_audio(s, seed=20 + i) for i, s in enumerate((4, 9, 17, 30))]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        wav20 = Path(tmp) / "speech20.wav"
        write_wav(wav20, synth_audio(20, seed=6))
        logmel.LOGMEL_LAUNCHES = attn.ATTN_LAUNCHES = 0
        mega.MEGA_LAUNCHES = mega.MEGA_VERIFY_LAUNCHES = q4.Q4_LAUNCHES = 0
        r20 = timed("20 s WAV, word timestamps, batch 1", lambda: pipe(
            str(wav20), return_timestamps="word",
            generate_kwargs=dict(GEN_KW)), tag="S4")
        q4_batch1 = q4.Q4_LAUNCHES
        rb = timed("transcribe_batch of 4 (4, 9, 17, 30 s)",
                   lambda: pipe.transcribe_batch(
                       batch, return_timestamps="word",
                       generate_kwargs=dict(GEN_KW)), tag="S4")
        launches = {"logmel": logmel.LOGMEL_LAUNCHES,
                    "encoder_attention": attn.ATTN_LAUNCHES,
                    "mega_step": mega.MEGA_LAUNCHES,
                    "mega_verify": mega.MEGA_VERIFY_LAUNCHES,
                    "int4_linear": q4.Q4_LAUNCHES}
    engine._generate = generate
    print(f"[S4] kernel launches on the S4 path: {launches}", flush=True)
    check([r.tokens.shape[0] for r in results] == [1, 4],
          f"S4 engine calls {[r.tokens.shape for r in results]}")
    steps = [r.decode_steps for r in results]
    want = [2 * n + 6 * n * (1 + s) for s in steps]
    check(steps[0] > 0 and q4_batch1 == want[0]
          and launches["int4_linear"] == sum(want),
          f"S4: Q4 launches {q4_batch1}, {launches['int4_linear']} != "
          f"{want} (cross K/V, prefill and {steps} step calls)")
    check(launches["mega_step"] == launches["mega_verify"] == 0,
          "S4: K3 or K4 launched")
    check(launches["logmel"] == 2
          and launches["encoder_attention"] == 2 * arch.encoder_layers,
          f"S4: K1/K2 launches {launches}")
    check_word_chunks(r20, 20.0, ordered=True)
    check(len(rb) == 4, "S4: transcribe_batch rows")
    for r, a in zip(rb, batch):
        check_word_chunks(r, len(a) / SAMPLE_RATE, ordered=True)
    for res in results:
        check(bool(np.isfinite(res.token_logprobs).all()
                   and np.isfinite(res.sum_logprob).all()
                   and np.isfinite(res.align).all()), "S4 result not finite")
    print(f"[S4] 20 s: {len(r20['chunks'])} words, {steps[0]} step calls; "
          f"batch: {[len(r['chunks']) for r in rb]} words, {steps[1]} step "
          f"calls; Q4 {q4_batch1} launches at batch 1 = 2 x 32 + 6 x 32 x "
          f"(1 + {steps[0]})", flush=True)
    del engine, pipe, results
    s4 = {b: graph_vs_eager(f"S4 B={b}", model, b, smi, cross_kv_int8=True)
          for b in (1, 4)}
    saved, model_s.mega = model_s.mega, None
    try:
        s_plain = {b: step_ms(model_s, b, megakernel=False) for b in (1, 4)}
    finally:
        model_s.mega = saved
    s_k3 = step_ms(model_s, 1)
    print(f"[S4] ms a step from the graph (host clock p50 / device), 30 s, "
          f"64 new tokens: S4 B=1 {s4[1]['graph_ms']:.4f} / "
          f"{s4[1]['device_ms']:.4f}, B=4 {s4[4]['graph_ms']:.4f} / "
          f"{s4[4]['device_ms']:.4f}; S plain int8 step B=1 "
          f"{s_plain[1][0]:.4f} / {s_plain[1][1]:.4f}, B=4 {s_plain[4][0]:.4f}"
          f" / {s_plain[4][1]:.4f}; S K3 B=1 {s_k3[0]:.4f} / {s_k3[1]:.4f}; "
          f"{smi}", flush=True)
    s4_small_reference()
    entry = phase_q4(model, smi)
    return launches["int4_linear"], entry, model


PROFILE_REPLAYS = 8      # [PROFILE] (b): traced replays of the S4 step graph
# (c) traces a call on the long-form file's first 120 s (its first 20
# windows): on an H100 the whole 600 s call's trace held 3.3 M events
# (966 MiB) and the profiler's host work stretched the call from 7.3 s
# to 72 s.
PROFILE_LONGFORM_SECONDS = 120
PROFILE_TOP = 8          # (b)'s largest kernels by device time


def kernel_events(events: list, what: str) -> list:
    """The trace's device kernels; a trace without one fails the run."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(len(kernels) > 0, f"[PROFILE] the trace of {what} holds no CUDA kernel event")
    return kernels


def spans_named(events: list, prefix: str) -> list:
    """The ``annotate`` spans whose name starts with ``prefix``, in time order."""
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda e: e["ts"])


def short(name: str) -> str:
    """A kernel's demangled name without its return type, anonymous
    namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:60]


def replay_split(events: list, prefix: str, n: int) -> dict:
    """Device work of ``n`` CUDA-graph replays traced each in an
    ``annotate`` span named ``prefix`` + its index: a replay's kernels and
    copies are those that carry the correlation id of the graph launch in
    its span. Summed over the replays: the device's span from a replay's
    first operation to its last (``span_us``), the union of its operations
    (``busy_us``), the span less that (``idle_us``), the kernels' summed
    time (``kernel_us``) and name -> (launches, summed us), the copies'
    summed time (``copy_us``). The counts are a replay's: every replay runs
    the same graph, and the tracer drops a record now and then (1 of some
    31,600 in a trace of the S4 step), so each name's count is the largest
    any replay shows, and ``dropped`` says how many records fell short of
    it."""
    kernel_events(events, f"the {prefix!r} replays")
    replays = spans_named(events, prefix)
    check(len(replays) == n, f"[PROFILE] {len(replays)} {prefix!r} spans, not {n}")
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e["name"]]
    by_corr = {}
    for e in events:
        if e.get("cat") in profiling.DEVICE_CATEGORIES:
            by_corr.setdefault(e.get("args", {}).get("correlation"), []).append(e)
    out = {"span_us": 0.0, "busy_us": 0.0, "kernel_us": 0.0, "copy_us": 0.0}
    counts = []
    for r in replays:
        mine = [e for e in launches if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
        check(len(mine) == 1, f"[PROFILE] {r['name']} holds {len(mine)} graph launches")
        ops = by_corr.get(mine[0]["args"]["correlation"], [])
        check(len(ops) > 0, f"[PROFILE] {r['name']}'s graph launch ran no kernel")
        lo, hi = min(e["ts"] for e in ops), max(e["ts"] + e["dur"] for e in ops)
        out["span_us"] += hi - lo
        out["busy_us"] += profiling.device_idle(ops, lo, hi)[0]
        out["kernel_us"] += sum(e["dur"] for e in ops if e["cat"] == "kernel")
        out["copy_us"] += sum(e["dur"] for e in ops if e["cat"] != "kernel")
        counts.append((profiling.kernel_times(ops),
                       sum(1 for e in ops if e["cat"] != "kernel")))
    names = set().union(*(c for c, _ in counts))
    launches_a_replay = {name: max(c[name][0] if name in c else 0 for c, _ in counts)
                         for name in names}
    out["by_name"] = {name: (launches_a_replay[name], sum(c[name][1] for c, _ in counts
                                                          if name in c))
                      for name in names}
    out["kernels"] = sum(launches_a_replay.values())
    out["copies"] = max(k for _, k in counts)
    out["dropped"] = sum(out["kernels"] - sum(v[0] for v in c.values())
                         for c, _ in counts)
    out["idle_us"] = out["span_us"] - out["busy_us"]
    return out


def phase_profile_shares(model, smi: str) -> None:
    """[PROFILE] (a) ``utils/flops.py``'s shares as the JAX bench computes
    them (``bench.py`` 975-999), for bf16 large-v3-turbo at full width: the
    encoder's MFU at B = 32 x 30 s (``t_mel`` 3000; CUDA events over three
    passes after a warm one), and the decode step's MFU and HBM share at
    B = 32 (``cache_len`` 84, ``t_enc`` 1500, bf16 weights, self-cache and
    cross K/V), the step's device time from a replay of its CUDA graph
    (``replay_ms``). Each share must fall in (0, 1]."""
    arch = model.arch
    feat = LogMelFeaturizer(n_mels=arch.n_mels, device=model.device)
    mel = feat([synth_audio(30, seed=100 + i) for i in range(32)])
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: encoder_forward(model, mel), iters=3)
    enc_flops = encoder_flops(arch, 3000, 32)
    engine = WhisperEngine(model)
    engine.warmup(3000, (32,), GEN_KW["max_new_tokens"], True)
    engine.transcribe_features(mel, GenerationOptions(
        language="en", max_new_tokens=GEN_KW["max_new_tokens"], return_timestamps=True))
    (key,) = [p["key"] for p in engine.programs()]
    step_ms = replay_ms(engine, key)
    step_flops = decode_step_flops(arch, cache_len=84, t_enc=1500, batch=32)
    step_bytes = decode_step_bytes(arch, cache_len=84, t_enc=1500, batch=32,
                                   weight_bytes=2, cache_bytes=2, cross_bytes=2)
    shares = {"encoder_bs32_mfu": enc_flops / (enc_ms / 1e3) / BF16_FLOPS,
              "decode_bs32_mfu": step_flops / (step_ms / 1e3) / BF16_FLOPS,
              "decode_bs32_hbm_util": step_bytes / (step_ms / 1e3) / HBM_BYTES_PER_S}
    print(f"[PROFILE] (a) bf16 turbo encoder B=32 x 30 s: {enc_ms:.3f} ms (CUDA "
          f"events), {enc_flops:.6e} FLOPs, MFU {shares['encoder_bs32_mfu']:.4f} of "
          f"{BF16_FLOPS:.4g} FLOP/s; {smi}", flush=True)
    print(f"[PROFILE] (a) bf16 turbo decode step B=32 (key {key}): {step_ms:.4f} ms "
          f"(device, CUDA graph), {step_flops:.6e} FLOPs and {step_bytes:.6e} bytes "
          f"at cache_len 84, t_enc 1500: MFU {shares['decode_bs32_mfu']:.4f}, HBM "
          f"share {shares['decode_bs32_hbm_util']:.4f} of {HBM_BYTES_PER_S:.4g} B/s; "
          f"{smi}", flush=True)
    for name, share in shares.items():
        check(0 < share <= 1, f"[PROFILE] {name} {share} outside (0, 1]")
    del engine, mel


def phase_profile_s4(model, smi: str) -> None:
    """[PROFILE] (b) Where the large-v3 "S4" step's time goes: ``trace()``
    around ``PROFILE_REPLAYS`` replays of its batch-1 CUDA graph (30 s, 64
    new tokens, word timestamps; [S4]'s model, a warmed engine of its own),
    each replay in an ``annotate`` span that ends in a synchronize
    (``replay_split``). A step: the device's span from a replay's first
    operation to its last, over ``STEPS_PER_CHECK``; its kernels, copies
    and Q4's launches (which must be [S4]'s 6 a layer); Q4's share of the
    span; the eight largest kernels by device time; the idle time inside
    the span (the span less the union of its operations). Beside them the
    step's untraced device time (``replay_ms``), which the tracer's own
    cost between kernels does not stretch, less the traced operations'
    time, and the host clock's ms a step of the same loop (``loop_ms``)."""
    n_q4 = 6 * model.arch.decoder_layers
    engine = WhisperEngine(model, cross_kv_int8=True)
    engine.warmup(3000, (1,), GEN_KW["max_new_tokens"], True)
    feat = LogMelFeaturizer(n_mels=model.arch.n_mels, device=model.device)
    engine.transcribe_features(feat([synth_audio(30, seed=90)]), GenerationOptions(
        language="en", max_new_tokens=GEN_KW["max_new_tokens"], return_timestamps=True))
    (key,) = [p["key"] for p in engine.programs()]
    host_ms = loop_ms(engine, key)[0]
    device_ms = replay_ms(engine, key)
    graph = engine._programs[key].graph
    graph.replay()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir):
            for i in range(PROFILE_REPLAYS):
                with profiling.annotate(f"s4 replay {i}"):
                    graph.replay()
                    torch.cuda.synchronize()
        events = profiling.trace_events(log_dir)
    split = replay_split(events, "s4 replay ", PROFILE_REPLAYS)
    steps, by_name = PROFILE_REPLAYS * STEPS_PER_CHECK, split["by_name"]
    span_us, idle_us, kernel_us = split["span_us"], split["idle_us"], split["kernel_us"]
    q4_names = [n for n in by_name if short(n).startswith("q4_")]
    q4_launches = sum(by_name[n][0] for n in q4_names) / STEPS_PER_CHECK
    q4_us = sum(by_name[n][1] for n in q4_names)
    check(q4_launches == n_q4, f"[PROFILE] Q4 launches a step {q4_launches} != {n_q4}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:PROFILE_TOP]
    work_ms = (kernel_us + split["copy_us"]) / 1e3 / steps
    print(f"[PROFILE] (b) large-v3 S4 step, batch 1, from its CUDA graph "
          f"({PROFILE_REPLAYS} traced replays of {STEPS_PER_CHECK} steps): device "
          f"span {span_us / 1e3 / steps:.4f} ms a step, of which kernels "
          f"{kernel_us / 1e3 / steps:.4f} ms, copies {split['copy_us'] / 1e3 / steps:.4f} "
          f"ms and idle {idle_us / 1e3 / steps:.4f} ms ({idle_us / span_us:.2%}); "
          f"{split['kernels'] / STEPS_PER_CHECK:g} kernels and "
          f"{split['copies'] / STEPS_PER_CHECK:g} copies a step ({split['dropped']} "
          f"records the tracer dropped); Q4 {q4_launches:g} launches a step, "
          f"{q4_us / 1e3 / steps:.4f} ms, {q4_us / span_us:.2%} of the span; "
          f"untraced, the step takes {device_ms:.4f} ms on the device (CUDA events "
          f"around replays), {device_ms - work_ms:.4f} ms more than its traced "
          f"kernels and copies, and {host_ms:.4f} ms on the host clock (p50 of 5, "
          f"the loop with its host checks); {smi}", flush=True)
    print("[PROFILE] (b) largest kernels by device time a step: " + "; ".join(
        f"{short(name)} x{cnt / STEPS_PER_CHECK:g} {us / 1e3 / steps:.4f} ms "
        f"({us / kernel_us:.1%})" for name, (cnt, us) in top), flush=True)
    del engine


def phase_profile_longform(arms: dict, smi: str) -> None:
    """[PROFILE] (c) The device's idle share in a batch-1 long-form call,
    on [LONGFORM]'s turbo "S" batch-1 depth-2 arm (warmed there): a call on
    the 600 s file's first ``PROFILE_LONGFORM_SECONDS``, once to warm its
    upload, once timed and once inside ``trace()``, its stages wrapped in
    ``annotate`` spans (the engine's dispatch, encoder queueing, decode
    loop and unpacking to the host; the pipeline's per-window consumption
    and token decoding). The device's busy time is the union of its
    kernels and copies over the traced call's span; the profiler's host
    work stretches the span, so the idle share is given over the traced
    span and against the untraced call's wall. The three longest idle gaps
    are printed with the innermost span and host op running at their
    start."""
    (name,) = [n for n in arms if n.startswith("S B1 depth 2")]
    pipe, bsz = arms[name]
    engine = pipe.engine
    audio = synth_audio(LONGFORM_SECONDS, seed=60)[:PROFILE_LONGFORM_SECONDS * SAMPLE_RATE]

    def call():
        out = pipe(audio, chunk_length_s=9, generate_kwargs=dict(LONGFORM_KW),
                   batch_size=bsz)
        torch.cuda.synchronize()
        check(out["text"].strip() != "", "[PROFILE] (c) a call gave no text")

    def spanned(label, fn):
        def run(*a, **k):
            with profiling.annotate(label):
                return fn(*a, **k)
        return run

    call()
    t0 = time.perf_counter()
    call()
    plain_wall = time.perf_counter() - t0
    stages = [(engine, "_dispatch", "dispatch"), (engine, "_decode", "decode"),
              (engine, "_unpack", "unpack"), (pipe, "_consume_result", "consume"),
              (pipe, "_decode", "tokens to text")]
    encode = PendingResult.encode
    for obj, attr, label in stages:
        setattr(obj, attr, spanned(label, getattr(obj, attr)))
    PendingResult.encode = spanned("encode", encode)
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            t0 = time.perf_counter()
            with profiling.trace(log_dir):
                with profiling.annotate("longform call"):
                    call()
            wall = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in Path(log_dir).iterdir())
            events = profiling.trace_events(log_dir)
    finally:
        for obj, attr, _ in stages:
            delattr(obj, attr)
        PendingResult.encode = encode
    kernel_events(events, "the long-form call")
    (span,) = spans_named(events, "longform call")
    start, end = span["ts"], span["ts"] + span["dur"]
    busy, gaps = profiling.device_idle(events, start, end)
    host = [e for e in events if e.get("cat") in ("user_annotation", "cpu_op")
            and e.get("tid") == span["tid"] and e["ts"] >= start]

    def running(t: float, cat: str) -> str:
        inside = [e for e in host if e["cat"] == cat and e["ts"] <= t < e["ts"] + e["dur"]]
        return max(inside, key=lambda e: e["ts"])["name"] if inside else "none"

    print(f"[PROFILE] (c) turbo S long-form, {name}, the 600 s file's first "
          f"{PROFILE_LONGFORM_SECONDS} s: untraced wall {plain_wall:.3f} s; traced "
          f"wall {wall:.3f} s, span {span['dur'] / 1e6:.3f} s, device busy "
          f"{busy / 1e6:.3f} s; idle share {1 - busy / span['dur']:.4f} over the "
          f"traced span, {1 - busy / 1e6 / plain_wall:.4f} against the untraced "
          f"wall; {len(events)} trace events, {size / 2 ** 20:.1f} MiB; {smi}",
          flush=True)
    for i, (lo, hi) in enumerate(gaps[:3]):
        print(f"[PROFILE] (c) idle gap {i + 1}: {(hi - lo) / 1e3:.3f} ms at "
              f"{(lo - start) / 1e6:.3f} s into the traced call; span "
              f"{running(lo, 'user_annotation')!r}, host op {running(lo, 'cpu_op')!r}; "
              f"{smi}", flush=True)


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    """(max abs err, max abs err relative to the reference's largest value)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def phase_control(smi: str) -> dict:
    """[P1] The no-exp attention control against its plain version at
    B = 4 (a grid of 80 heads) and at the probe's B = 32 (640 heads), H = 20,
    S = 1536, bf16: within 2e-2 of the largest value (the outputs reach the
    thousands; a score summed in another order may round p to the other
    bf16 neighbour); f32 (the CUDA-core route) at B = 1, H = 20, S = 1024
    within 1e-5 (the same f32 math summed in another order). The plain
    version holds one 512-key tile of f32 scores at a time (2 GB at B = 32).
    The B = 32 bf16 call is timed eagerly and from a CUDA graph, and must
    take at most 3.2 ms, beside K2 and ``scaled_dot_product_attention`` on
    the same inputs: softmax attention, yardsticks only, as no PyTorch call
    computes P1's function (``library_ms`` is null)."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(32, 20, 1536, 64, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    for b in (4, 32):
        out = control.attention_control(q[:b], k[:b], v[:b])
        ref = control.attention_control_plain(q[:b], k[:b], v[:b])
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == q.dtype, "P1 output")
        err, rel = rel_err(out, ref)
        print(f"[P1] B={b} H=20 S=1536 bf16: max abs err {err:.3e} (rel to "
              f"max {rel:.3e}; largest value {ref.float().abs().max().item():.1f})",
              flush=True)
        check(rel <= 2e-2, f"P1 rel err {rel} at B={b}")
    del ref
    qf, kf, vf = (torch.randn(1, 20, 1024, 64, generator=g, device=dev)
                  for _ in range(3))
    f32_err, f32_rel = rel_err(control.attention_control(qf, kf, vf),
                               control.attention_control_plain(qf, kf, vf))
    print(f"[P1] B=1 H=20 S=1024 f32: max abs err {f32_err:.3e} (rel to max "
          f"{f32_rel:.3e})", flush=True)
    check(f32_rel <= 1e-5, f"P1 f32 rel err {f32_rel}")
    ms = cuda_ms(lambda: control.attention_control(q, k, v), iters=10)
    dev_ms = graph_ms(lambda: control.attention_control(q, k, v), calls=4)
    plain_ms = cuda_ms(lambda: control.attention_control_plain(q, k, v), iters=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    k2_ms = cuda_ms(lambda: attn.encoder_attention(qt, kt, vt), iters=10)
    sdpa_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
        iters=10)
    flops = 4 * 32 * 20 * 1536 ** 2 * 64
    print(f"[P1] B=32 H=20 S=1536 bf16: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s of the function's work, {flops / ms * 1e3 / BF16_FLOPS:.1%} "
          f"of the bf16 peak), device {dev_ms:.4f} ms (CUDA graph); "
          f"plain {plain_ms:.4f} ms; yardsticks on the same inputs: K2 "
          f"{k2_ms:.4f} ms, scaled_dot_product_attention {sdpa_ms:.4f} ms; "
          f"{smi}", flush=True)
    check(ms <= 3.2, f"P1 bf16 {ms} ms at B=32 (requirement: at most 3.2 ms)")
    return {"max_abs_err": err, "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms,
            **bound(nbytes(q, k, v, out), flops, BF16_FLOPS),
            "library_ms": None, "k2_same_shape_ms": k2_ms,
            "sdpa_same_shape_ms": sdpa_ms}


MLP_PHASES = ("LN2 + fc1 + GELU", "fc2")
# [P2]/[P3]'s requirements at L = 32 from a CUDA graph, ms: P2, and P3 over
# the 32 layers in turn.
P2_MAX_MS = 0.55
P3_X32_MAX_MS = 0.70


def phase_mlp(smi: str):
    """[P2]/[P3] The int8 MLP chain at the probe's widths (d_model 1280,
    d_ff 5120) with random LayerNorm parameters, the weights packed once
    (``pack_mlp_weights``, timed on its own): P2 against its plain version
    within 2e-2 of the largest value at L = 32 (K3's bound at that depth:
    bf16 roundings that go the other way cascade) and within 1e-2 at
    L = 1; P3 over the 32 layers in turn equals P2 bit for bit. Device
    times from CUDA-graph replays: P2 at L = 32 (at most ``P2_MAX_MS``),
    P3 over the 32 distinct layers (at most ``P3_X32_MAX_MS``; each
    layer's 13.1 MB come from device memory, and P3's ``ms`` is a 32nd of
    it) and P3 on layer 0 replayed (its weights stay in the 50 MB L2:
    ``l2_resident_ms``); the plain versions and eager calls beside them,
    and the phase stamps of one P2 launch. P3's plain time is a 32nd of the
    plain chain's. Returns the kernels-line entries of P2 and P3."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(12)
    p = gemv_chain_probe.make_inputs(32, 1280, 5120, g, dev)
    x, ops = p["x"], gemv_chain_probe.operands(p)
    one = [t[:1] for t in ops]
    packed = mlp.pack_mlp_weights(p["w1"], p["w2"])
    packed1 = mlp.pack_mlp_weights(one[6], one[7])
    pack_ms = cuda_ms(lambda: mlp.pack_mlp_weights(p["w1"], p["w2"]), iters=3)
    with torch.inference_mode():
        chain = mlp.mlp_chain(x, *ops, packed=packed)
        err, rel = rel_err(chain, mlp.mlp_chain_plain(x, *ops))
        err1, rel1 = rel_err(mlp.mlp_chain(x, *one, packed=packed1),
                             mlp.mlp_chain_plain(x, *one))
        y = x
        for l in range(32):
            y = mlp.mlp_layer(y, l, *ops, packed=packed)
        same = torch.equal(y, chain)
        layer_err, _ = rel_err(mlp.mlp_layer(x, 0, *ops, packed=packed),
                               mlp.mlp_layer_plain(x, 0, *ops))
    print(f"[P2] L=32: max abs err {err:.3e} (rel {rel:.3e}); L=1: {err1:.3e} "
          f"(rel {rel1:.3e}); mlp_layer x 32 == mlp_chain: {same}", flush=True)
    check(rel <= 2e-2, f"P2 L=32 rel err {rel}")
    check(rel1 <= 1e-2, f"P2 L=1 rel err {rel1}")
    check(same, "P3 x 32 differs from P2")

    def by_layer():
        z = x
        for l in range(32):
            z = mlp.mlp_layer(z, l, *ops, packed=packed)
        return z

    # Device times from CUDA-graph replays (the wrapper's host work, 20-80 us
    # a call, would otherwise hide P3's launch boundaries); eager beside.
    with torch.inference_mode():
        ms = graph_ms(lambda: mlp.mlp_chain(x, *ops, packed=packed), calls=4)
        chain_plain_ms = graph_ms(lambda: mlp.mlp_chain_plain(x, *ops), calls=2)
        by_layer_ms = graph_ms(by_layer, calls=4)
        l2_ms = graph_ms(lambda: mlp.mlp_layer(x, 0, *ops, packed=packed))
        eager = (cuda_ms(lambda: mlp.mlp_chain(x, *ops, packed=packed)),
                 cuda_ms(by_layer, iters=10))
        stamps = mlp.stamps_tensor(32, dev)
        mlp.mlp_chain(x, *ops, packed=packed, stamps=stamps)
        torch.cuda.synchronize()
    gb = gemv_chain_probe.weight_bytes(p) / 1e9
    print(f"[P2] L=32: kernel {ms:.4f} ms ({gb / ms * 1e3:.1f} GB/s of {gb:.4f} "
          f"GB of weights), plain {chain_plain_ms:.4f} ms; [P3] 32 launches over "
          f"distinct layers {by_layer_ms:.4f} ms ({by_layer_ms / 32:.5f} a layer, "
          f"{gb / by_layer_ms * 1e3:.1f} GB/s), layer 0 replayed (L2-resident) "
          f"{l2_ms:.4f} ms (CUDA graph); "
          f"eager P2 {eager[0]:.4f} ms, P3 x 32 {eager[1]:.4f} ms; the pack "
          f"(once, outside these) {pack_ms:.4f} ms; {smi}", flush=True)
    summary = stamp_table("P2 L=32", stamps, 32, MLP_PHASES, final=False)
    check(ms <= P2_MAX_MS, f"P2 {ms} ms at L=32 (requirement: at most {P2_MAX_MS})")
    check(by_layer_ms <= P3_X32_MAX_MS,
          f"P3 x 32 {by_layer_ms} ms (requirement: at most {P3_X32_MAX_MS})")
    moved = nbytes(x, *ops) + nbytes(chain)
    return ({"max_abs_err": err, "ms": ms, "plain_ms": chain_plain_ms,
             **bound(moved, 4 * 32 * 1280 * 5120, BF16_FLOPS),
             "library_ms": None, "pack_ms": pack_ms, "stamps": summary},
            {"max_abs_err": layer_err, "ms": by_layer_ms / 32,
             "plain_ms": chain_plain_ms / 32,
             **bound(moved / 32, 4 * 1280 * 5120, BF16_FLOPS),
             "library_ms": None, "l2_resident_ms": l2_ms})


# [P4]/[P5]'s requirement: from CUDA graphs timed in turns in one phase,
# each kernel at most this times the torch in-place write (and P5 at most
# this times ``index_copy_``); the 10% is for the noise of microsecond
# timings.
CACHE_WRITE_MAX_RATIO = 1.1
# P5 HBM-cold: 16 slots 15 columns apart (the probe's T = 228 holds no 16
# slots 16 apart), one write a slot: 16 x 5.24 MB of sectors, against the
# 50 MB L2.
COLD_SLOTS = tuple(15 * i for i in range(16))


def graph_turns(fns: dict, rounds: int = 5, calls: int = 16, iters: int = 10) -> dict:
    """Device ms a call of each of ``fns`` (name -> fn): each captured once
    as ``calls`` calls in a CUDA graph, then its replays timed with CUDA
    events in ``rounds`` rounds of turns (the order reversed every other
    round); the median of its rounds. Arguments a fn reads when it is
    called are fixed at capture; a device slot is read at replay."""
    graphs = {name: capture(fn, calls) for name, fn in fns.items()}
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(graphs) if r % 2 == 0 else list(graphs)[::-1]):
            times[name].append(cuda_ms(graphs[name].replay, iters) / calls)
    return {name: float(np.median(t)) for name, t in times.items()}


def cycling(values):
    """A function returning ``values`` in turn, one a call."""
    state = {"i": -1}

    def take():
        state["i"] = (state["i"] + 1) % len(values)
        return values[state["i"]]
    return take


def eager(fn) -> float:
    """Device ms a call of ``fn`` called eagerly (the host's launch cost
    included): the median of three runs of 100 calls."""
    return float(np.median([cuda_ms(fn, iters=100) for _ in range(3)]))


def slot_tensor(pos: int, dev) -> torch.Tensor:
    return torch.tensor([pos], dtype=torch.int32, device=dev)


def check_replayed_slots(dev, g) -> None:
    """(c) 16 P4 writes and 16 P5 writes captured reading ``slots[i]``; the
    slots refilled on the card after capture; the replay must put each row
    and column at its new slot, bit for bit, and nothing elsewhere."""
    rows, cols = (torch.randn(16, 1280, generator=g, device=dev).to(torch.bfloat16),
                  torch.randn(16, 128, 1280, 1, generator=g, device=dev).to(torch.bfloat16))
    for name, cache, n_slots in (("P4", torch.zeros(448, 1280, dtype=torch.bfloat16, device=dev), 448),
                                 ("P5", torch.zeros(128, 1280, 228, dtype=torch.bfloat16, device=dev), 228)):
        slots = torch.arange(16, dtype=torch.int32, device=dev)
        views = slots.split(1)

        def writes():
            for i in range(16):
                if name == "P4":
                    cw.write_row(cache, views[i], rows[i])
                else:
                    cw.write_column(cache, cols[i], views[i])
        graph = capture(writes)
        new = torch.randperm(n_slots, generator=g, device=dev)[:16]
        slots.copy_(new.to(torch.int32))
        cache.zero_()
        graph.replay()
        ref = torch.zeros_like(cache)
        for i, pos in enumerate(new.tolist()):
            if name == "P4":
                cw.write_row_plain(ref, pos, rows[i])
            else:
                cw.write_column_plain(ref, cols[i], pos)
        torch.cuda.synchronize()
        check(torch.equal(cache, ref), f"{name} graph replayed at slots refilled on the card")
    print("[P4]/[P5] device slots: 16 writes captured, the slots refilled on the "
          "card, the replay bit-exact at the new slots, nothing elsewhere", flush=True)


def check_relay(dev, g) -> None:
    """(d) PDL ordering: P5 writes column 7 of a (128, 1280, 256) cache A,
    then P4 copies row j of A's (R F, 256) view, a row crossing column 7,
    into slot k of B, then P4 copies B's row k into slot k of C; 16 rounds
    with a fresh column and another j each. Eager (the launches queued
    behind a 5 ms sleep kernel, so the card runs them back to back) and
    from a CUDA graph; A, B and C must equal the plain versions bit for
    bit. A kernel that touched memory before ``griddepcontrol.wait`` would
    read a column or a row before its predecessor wrote it."""
    a0 = torch.randn(128, 1280, 256, generator=g, device=dev).to(torch.bfloat16)
    cols = torch.randn(16, 128, 1280, 1, generator=g, device=dev).to(torch.bfloat16)
    rf = 128 * 1280
    js = [rf - 1 - k * (rf // 16) for k in range(16)]

    def relay(a, b, c, column, row):
        for k in range(16):
            column(a, cols[k], 7)
            row(b, k, a.view(rf, 256)[js[k]])
            row(c, k, b[k])
    want = [a0.clone(), torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
            torch.zeros(16, 256, dtype=torch.bfloat16, device=dev)]
    relay(*want, cw.write_column_plain, cw.write_row_plain)
    got = [a0.clone(), torch.zeros_like(want[1]), torch.zeros_like(want[2])]
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    relay(*got, cw.write_column, cw.write_row)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, want)), "P5 -> P4 -> P4 relay, eager")
    got = [a0.clone(), torch.zeros_like(want[1]), torch.zeros_like(want[2])]
    graph = capture(lambda: relay(*got, cw.write_column, cw.write_row))
    got[0].copy_(a0)
    got[1].zero_()
    got[2].zero_()
    graph.replay()
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, want)), "P5 -> P4 -> P4 relay, graph")
    print("[P4]/[P5] relay P5 -> P4 -> P4 (16 rounds), eager and from a CUDA graph: "
          "bit-exact", flush=True)


def phase_cache_writes(smi: str):
    """[P4]/[P5] The slot writes at the probes' shapes against their plain
    versions, bit for bit, every other slot unchanged, with host and device
    slots; the device-slot replay (``check_replayed_slots``) and the PDL
    relay (``check_relay``). Device times from CUDA graphs timed in turns:
    the launch floor (an empty kernel in a 16-node graph, with and without
    PDL), each kernel beside the torch in-place write (the plain version,
    one PyTorch call) and ``index_copy_``; P5 L2-resident (16 writes to one
    column, ``l2_resident_ms``, the ``ms`` of its entry) and HBM-cold (16
    device slots 15 columns apart, ``cold_ms``), beside its sector floor
    (R F 32-byte sectors over 3.35 TB/s); eager kernel calls beside.
    Asserts ``CACHE_WRITE_MAX_RATIO``. Returns the kernels-line entries of
    P4 and P5."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(13)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    floors = graph_turns({"plain launch": lambda: cw.empty_launch(dev, False),
                          "PDL": lambda: cw.empty_launch(dev, True)})
    floor, floor_pdl = floors["plain launch"], floors["PDL"]
    eager_floors = [eager(lambda pdl=pdl: cw.empty_launch(dev, pdl)) for pdl in (False, True)]
    print(f"[P4]/[P5] launch floor, an empty kernel in a 16-node CUDA graph: "
          f"{floor * 1e3:.3f} us, with PDL {floor_pdl * 1e3:.3f} us; eager "
          f"{eager_floors[0] * 1e3:.2f} us, with PDL {eager_floors[1] * 1e3:.2f} us; "
          f"{smi}", flush=True)
    floor_keys = {"launch_floor_ms": floor, "launch_floor_pdl_ms": floor_pdl}

    for shape, pos in (((448, 1280), 13), ((32 * 448, 1280), 9000)):
        cache, row = rand(*shape), rand(1, shape[1])
        keep = torch.arange(shape[0], device=dev) != pos
        slot = slot_tensor(pos, dev)
        for given in (pos, slot):
            got = cw.write_row(cache.clone(), given, row)
            ref = cw.write_row_plain(cache.clone(), pos, row)
            exact = torch.equal(got, ref) and torch.equal(got[keep], cache[keep])
            check(exact, f"P4 at {shape}, row {pos} ({type(given).__name__} slot)")
        index = torch.tensor([pos], device=dev)
        t = graph_turns({"kernel": lambda: cw.write_row(cache, pos, row),
                         "device slot": lambda: cw.write_row(cache, slot, row),
                         "torch": lambda: cw.write_row_plain(cache, pos, row),
                         "index_copy_": lambda: cache.index_copy_(0, index, row)})
        eager_ms = eager(lambda: cw.write_row(cache, pos, row))
        print(f"[P4] {shape}: bit-exact with host and device slots, other rows "
              f"unchanged; kernel {t['kernel'] * 1e3:.3f} us (device slot "
              f"{t['device slot'] * 1e3:.3f})  torch in-place {t['torch'] * 1e3:.3f} us  "
              f"index_copy_ {t['index_copy_'] * 1e3:.3f} us (CUDA graphs in turns; "
              f"{t['kernel'] / floor_pdl:.2f}x the PDL launch floor); eager kernel "
              f"call {eager_ms * 1e3:.2f} us; {smi}", flush=True)
        check(t["kernel"] <= CACHE_WRITE_MAX_RATIO * t["torch"],
              f"P4 {t['kernel']} ms at {shape} (requirement: at most "
              f"{CACHE_WRITE_MAX_RATIO}x the torch in-place write, {t['torch']})")
    p4 = {"max_abs_err": 0.0, "ms": t["kernel"], "plain_ms": t["torch"],
          **bound(2 * nbytes(row), 0, BF16_FLOPS), "library_ms": t["index_copy_"],
          **floor_keys, "device_slot_ms": t["device slot"], "eager_ms": eager_ms}

    cache, col, pos = rand(128, 1280, 228), rand(128, 1280, 1), 7
    keep = torch.arange(228, device=dev) != pos
    slot = slot_tensor(pos, dev)
    for given in (pos, slot):
        got = cw.write_column(cache.clone(), col, given)
        ref = cw.write_column_plain(cache.clone(), col, pos)
        check(torch.equal(got, ref) and torch.equal(got[:, :, keep], cache[:, :, keep]),
              f"P5 column write ({type(given).__name__} slot)")
    index = torch.tensor([pos], device=dev)
    kernel_cold = cycling(torch.tensor(COLD_SLOTS, dtype=torch.int32, device=dev).split(1))
    torch_cold = cycling(COLD_SLOTS)
    t = graph_turns({
        "l2 kernel": lambda: cw.write_column(cache, col, slot),
        "cold kernel": lambda: cw.write_column(cache, col, kernel_cold()),
        "l2 torch": lambda: cw.write_column_plain(cache, col, pos),
        "cold torch": lambda: cw.write_column_plain(cache, col, torch_cold()),
        "l2 index_copy_": lambda: cache.index_copy_(2, index, col)})
    eager_ms = eager(lambda: cw.write_column(cache, col, slot))
    sector_floor = bound(128 * 1280 * 32, 0, BF16_FLOPS)["bound_ms"]
    l2, cold_ms = t["l2 kernel"], t["cold kernel"]
    print(f"[P5] (128, 1280, 228): bit-exact with host and device slots, other "
          f"slots unchanged; kernel (device slot) l2_resident {l2 * 1e3:.3f} us  "
          f"torch in-place {t['l2 torch'] * 1e3:.3f} us  index_copy_ "
          f"{t['l2 index_copy_'] * 1e3:.3f} us; HBM-cold (16 slots 15 apart) kernel "
          f"{cold_ms * 1e3:.3f} us  torch in-place {t['cold torch'] * 1e3:.3f} us; "
          f"sector floor {sector_floor * 1e3:.3f} us (+ PDL launch floor "
          f"{(sector_floor + floor_pdl) * 1e3:.3f}; cold is "
          f"{cold_ms / (sector_floor + floor_pdl):.2f}x that) (CUDA graphs in turns); "
          f"eager kernel call {eager_ms * 1e3:.2f} us; {smi}", flush=True)
    for name in ("torch", "index_copy_"):
        check(l2 <= CACHE_WRITE_MAX_RATIO * t[f"l2 {name}"],
              f"P5 L2-resident {l2} ms (requirement: at most {CACHE_WRITE_MAX_RATIO}x "
              f"{name}, {t[f'l2 {name}']})")
    p5 = {"max_abs_err": 0.0, "ms": l2, "plain_ms": t["l2 torch"],
          **bound(2 * nbytes(col), 0, BF16_FLOPS), "library_ms": t["l2 index_copy_"],
          **floor_keys, "cold_ms": cold_ms, "l2_resident_ms": l2,
          "sector_floor_ms": sector_floor, "plain_cold_ms": t["cold torch"],
          "eager_ms": eager_ms}
    check_replayed_slots(dev, g)
    check_relay(dev, g)
    return p4, p5


# The probe entry points as the smoke run drives them, each with the counts
# of the kernels on its path: the attention chain at the probe's widths but
# two layers deep (the 32-layer chain is the probe's own run), the others as
# a user runs them (the MLP chain with fewer repetitions).
PROBE_RUNS = (
    (attention_probe, ["--layers", "2", "--reps", "1"],
     lambda: {"attention_control": control.CONTROL_LAUNCHES}),
    (gemv_chain_probe, ["--hybrid", "--reps", "3"],
     lambda: {"mlp_chain": mlp.MLP_CHAIN_LAUNCHES,
              "mlp_layer": mlp.MLP_LAYER_LAUNCHES}),
    (mega_caps_probe, [], lambda: {"write_row": cw.ROW_LAUNCHES}),
    (cache_write_probe, [], lambda: {"write_column": cw.COLUMN_LAUNCHES}),
)


def phase_probes() -> dict:
    """The probes' path: each probe entry point runs once on the card with
    the launch counts set to 0 just before it and read just after; every
    kernel of its path must have launched."""
    launches = {}
    for probe, args, counts in PROBE_RUNS:
        control.CONTROL_LAUNCHES = mlp.MLP_CHAIN_LAUNCHES = 0
        mlp.MLP_LAYER_LAUNCHES = cw.ROW_LAUNCHES = cw.COLUMN_LAUNCHES = 0
        probe.main(args)
        launches.update(counts())
    print(f"[probes] kernel launches on the probes' path: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} did not launch on its probe's path")
    return launches


# ---------------------------------------------------------------------------
# [TRAIN] fine-tuning and draft distillation at turbo's full width


TRAIN_TOKENS = 128          # run_finetune.py's --max-tokens
# The backward kernels' cases: (B, S, valid_len), H = 20, f32 and bf16.
BWD_CASES = ((8, 500, None), (4, 1500, None), (1, 1500, 1100))
# bf16 K2-dkv + K2-dq at arm A's shape (B = 8, S = 500) against
# scaled_dot_product_attention's bf16 backward (all three gradients) on the
# same inputs.
BWD_BF16_VS_SDPA = 1.5
ARM_C_STEPS = 3


def phase_attention_backward(smi: str) -> dict:
    """K2 with lse (K2-fwd-res), K2-dkv and K2-dq against their plain
    versions at ``BWD_CASES``, f32 and bf16. Bounds: lse to 1e-4 absolute
    of ``attention_lse_plain`` (the logsumexp of the scaled scores; the
    kernels sum exp2 in the log2 domain); the output bit-equal to the
    inference launch's; f32 gradients to 1e-4 relative L2 of the plain
    backward on the same out and lse (f32 sums in another order); bf16
    gradients at most ``F32_RATIO`` times the plain bf16 backward's
    distance from the f32 gradients of the same inputs (both round P and
    dS to bf16). Times from CUDA events; ``scaled_dot_product_attention``'s
    forward (on inputs that require grad, so it keeps its residuals) and
    backward on the same inputs as yardsticks; in bf16 at arm A's shape
    (B = 8, S = 500) K2-dkv and K2-dq together must take at most
    ``BWD_BF16_VS_SDPA`` times that backward; in f32 there K2-fwd-res (3xTF32)
    must take at most that forward and K2-dkv and K2-dq together (3xTF32),
    the pair that computes what that backward computes, at most that whole
    backward. Returns the kernels-line entries at arm A's shape (f32, with
    ``tc_bound_ms``, the bound at the TF32 tensor rate for three products
    of each, and the bf16 route's time, bound and library time beside
    them)."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
        for b, s, valid_len in BWD_CASES:
            q, k, v, do = (torch.randn(b, s, 20, 64, generator=g, device=dev)
                           .to(dtype) for _ in range(4))
            valid = valid_len or s
            out, lse = attn.encoder_attention_residuals(q, k, v, valid_len)
            got = attn.encoder_attention_backward(q, k, v, out, lse, do, valid_len)
            torch.cuda.synchronize()
            lse_err = (lse - attn.attention_lse_plain(q, k, valid_len)).abs().max().item()
            check(lse_err <= 1e-4, f"K2 lse err {lse_err}")
            check(torch.equal(out, attn.encoder_attention(q, k, v, valid_len)),
                  "K2 with lse wrote another output than without")
            plain = attn.encoder_attention_backward_plain(q, k, v, out, lse, do,
                                                          valid_len)
            if valid < s:
                check(not got[1][:, valid:].any() and not got[2][:, valid:].any(),
                      "dK/dV of masked keys not zero")
            if dtype == torch.float32:
                errs = [l2_rel(x, r).item() for x, r in zip(got, plain)]
                check(max(errs) <= 1e-4, f"K2 backward f32 rel L2 {errs}")
                shown = "rel L2 dq/dk/dv " + " ".join(f"{e:.2e}" for e in errs)
            else:
                f = [x.float() for x in (q, k, v, do)]
                out32, lse32 = attn.encoder_attention_residuals(*f[:3], valid_len)
                ref = attn.encoder_attention_backward_plain(*f[:3], out32, lse32,
                                                            f[3], valid_len)
                errs = [f32_ratio(x, p, r) for x, p, r in zip(got, plain, ref)]
                check(max(errs) <= F32_RATIO, f"K2 backward bf16 ratios {errs}")
                shown = ("distance from f32 over the plain bf16's, dq/dk/dv "
                         + " ".join(f"{e:.3f}" for e in errs))
                del f, out32, lse32, ref
            di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
            fwd_ms = cuda_ms(lambda: attn.encoder_attention_residuals(q, k, v, valid_len))
            dkv_ms = cuda_ms(lambda: attn.launch_backward_dkv(q, k, v, do, lse, di, valid))
            dq_ms = cuda_ms(lambda: attn.launch_backward_dq(q, k, v, do, lse, di, valid))
            plain_ms = cuda_ms(lambda: attn.encoder_attention_backward_plain(
                q, k, v, out, lse, do, valid_len), iters=3)
            pairs = b * 20 * s * valid * 64       # (query, key, dim) triples
            io = nbytes(q, k, v, do, lse, di)
            moved = {"fwd_res": (nbytes(q, k, v, out, lse), 4 * pairs),
                     "dkv": (io + nbytes(*got[1:]), 8 * pairs),
                     "dq": (io + nbytes(got[0]), 6 * pairs)}
            bounds = {key: bound(*m, peak) for key, m in moved.items()}
            # The f32 routes' products as 3xTF32: three TF32 products each.
            tc_bounds = {key: bound(m[0], 3 * m[1], TF32_FLOPS)["bound_ms"]
                         for key, m in moved.items()}
            line = (f"[TRAIN] K2 backward {str(dtype)[6:]:>8} B={b} S={s} "
                    f"valid={valid_len}: lse max abs err {lse_err:.2e}, {shown}; "
                    f"fwd-res {fwd_ms:.4f} ms, dkv {dkv_ms:.4f} ms, dq "
                    f"{dq_ms:.4f} ms (bounds " + ", ".join(
                        f"{x['bound_ms']:.4f}" for x in bounds.values())
                    + (" ms; 3xTF32 " + ", ".join(f"{x:.4f}" for x in tc_bounds.values())
                       if dtype == torch.float32 else "")
                    + f" ms), plain backward {plain_ms:.4f} ms; "
                    f"{4 * pairs / fwd_ms / 1e9:.1f} TFLOP/s fwd-res, "
                    f"{8 * pairs / dkv_ms / 1e9:.1f} dkv, "
                    f"{14 * pairs / (dkv_ms + dq_ms) / 1e9:.1f} backward")
            lib_fwd = lib_bwd = None
            if valid_len is None:
                leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
                lib_fwd = cuda_ms(lambda: sdpa_attention(*leaves))
                lib_out = sdpa_attention(*leaves)
                lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, do, retain_graph=True))
                line += (f"; scaled_dot_product_attention forward {lib_fwd:.4f}"
                         f" ms, backward {lib_bwd:.4f} ms")
                del leaves, lib_out
            print(f"{line}; {smi}", flush=True)
            if (dtype, b, s, valid_len) == (torch.bfloat16, 8, 500, None):
                check(dkv_ms + dq_ms <= BWD_BF16_VS_SDPA * lib_bwd,
                      f"bf16 dK/dV + dQ {dkv_ms + dq_ms:.4f} ms over "
                      f"{BWD_BF16_VS_SDPA}x scaled_dot_product_attention's "
                      f"backward ({lib_bwd:.4f} ms)")
                for key, ms, lib in (("fwd_res", fwd_ms, lib_fwd), ("dkv", dkv_ms, lib_bwd),
                                     ("dq", dq_ms, lib_bwd)):
                    main[key].update(bf16_ms=ms, bf16_bound_ms=bounds[key]["bound_ms"],
                                     bf16_library_ms=lib)
            if (dtype, b, s, valid_len) == (torch.float32, 8, 500, None):
                check(fwd_ms <= lib_fwd,
                      f"f32 K2-fwd-res {fwd_ms:.4f} ms slower than "
                      f"scaled_dot_product_attention's f32 forward ({lib_fwd:.4f} ms)")
                check(dkv_ms + dq_ms <= lib_bwd,
                      f"f32 dK/dV + dQ {dkv_ms + dq_ms:.4f} ms slower than "
                      f"scaled_dot_product_attention's f32 backward ({lib_bwd:.4f} ms)")
                errs = [(x - r).abs().max().item() for x, r in zip(got, plain)]
                main = {
                    "fwd_res": {"max_abs_err": lse_err, "ms": fwd_ms,
                                "plain_ms": cuda_ms(lambda: attn.encoder_attention_plain(
                                    q, k, v, valid_len), iters=3),
                                **bounds["fwd_res"], "library_ms": lib_fwd},
                    "dkv": {"max_abs_err": max(errs[1:]), "ms": dkv_ms,
                            "plain_ms": plain_ms, **bounds["dkv"],
                            "library_ms": lib_bwd},
                    "dq": {"max_abs_err": errs[0], "ms": dq_ms, "plain_ms": plain_ms,
                           **bounds["dq"], "library_ms": lib_bwd},
                }
                for key in main:
                    main[key]["tc_bound_ms"] = tc_bounds[key]
            del q, k, v, do, out, lse, got, plain, di
            torch.cuda.empty_cache()
    return main


def train_batch(arch, b: int, seconds: int, seed: int) -> dict:
    """A synthetic fine-tuning batch as ``run_finetune.py`` builds one:
    seeded WAVs through K1 (a featurizer of ``seconds``), and token rows of
    the English transcribe prompt, 60-123 random text ids and EOT, padded
    with EOT to ``TRAIN_TOKENS``; the loss mask covers the text and EOT."""
    dev = torch.device("cuda", 0)
    sp = SpecialTokens.for_vocab(arch.vocab_size)
    prompt = [sp.sot, sp.language_id("en", LANGUAGES[: sp.n_languages]),
              sp.transcribe, sp.no_timestamps]
    rng = np.random.default_rng(seed)
    tokens = np.full((b, TRAIN_TOKENS), sp.eot, np.int64)
    mask = np.zeros((b, TRAIN_TOKENS), np.float32)
    for i in range(b):
        ids = prompt + list(rng.integers(0, sp.eot, rng.integers(60, 124))) + [sp.eot]
        tokens[i, : len(ids)] = ids
        mask[i, len(prompt): len(ids)] = 1.0
    featurizer = LogMelFeaturizer(n_mels=arch.n_mels, chunk_length_s=seconds,
                                  device=dev)
    mel = featurizer(np.stack([synth_audio(seconds, seed=seed * 100 + i)
                               for i in range(b)]))
    return {"mel": mel, **train.place_batch({"tokens": tokens, "loss_mask": mask}, dev)}


def grad_group(name: str) -> str:
    if name.startswith("encoder.layers.") and ".attn." in name:
        return "encoder attention"
    if name.startswith("encoder.layers.") and ".fc" in name:
        return "encoder MLP"
    if name.startswith("decoder.layers."):
        return "decoder"
    if name.endswith("_emb"):
        return "embeddings"
    return "rest"         # the conv stem and the LayerNorms of the encoder


def grads(model, batch, **kw):
    """(loss, {name: gradient}) of one ``train.loss_fn`` backward."""
    model.zero_grad(set_to_none=True)
    loss = train.loss_fn(model, batch, **kw)
    loss.backward()
    out = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), out


def group_l2(got: dict, ref: dict, plain: dict = None) -> dict:
    """Relative L2 distance of ``got`` from ``ref`` by ``grad_group``; with
    ``plain``, that distance over ``plain``'s (``F32_RATIO``'s rule)."""
    num, den, alt = {}, {}, {}
    for n, r in ref.items():
        grp = grad_group(n)
        num[grp] = num.get(grp, 0.0) + (got[n].float() - r.float()).square().sum().item()
        den[grp] = den.get(grp, 0.0) + r.float().square().sum().item()
        if plain is not None:
            alt[grp] = alt.get(grp, 0.0) + (plain[n].float() - r.float()).square().sum().item()
    if plain is None:
        return {grp: math.sqrt(num[grp] / den[grp]) for grp in num}
    return {grp: math.sqrt(num[grp] / alt[grp]) for grp in num}


def shown(d: dict, fmt: str = ".2e") -> str:
    return ", ".join(f"{k} {v:{fmt}}" for k, v in d.items())


def zero_train_counts() -> None:
    attn.ATTN_LAUNCHES = attn.ATTN_RES_LAUNCHES = 0
    attn.ATTN_BWD_DKV_LAUNCHES = attn.ATTN_BWD_DQ_LAUNCHES = 0


def train_counts() -> dict:
    return {"encoder_attention": attn.ATTN_LAUNCHES,
            "encoder_attention_fwd_res": attn.ATTN_RES_LAUNCHES,
            "encoder_attention_bwd_dkv": attn.ATTN_BWD_DKV_LAUNCHES,
            "encoder_attention_bwd_dq": attn.ATTN_BWD_DQ_LAUNCHES}


def train_steps(tag: str, state, step, batch, n: int, layers: int, remat: bool,
                smi: str):
    """``n`` steps on one batch, the counts zeroed just before: every step
    launches K2 with lse once a layer (twice with remat), each backward
    kernel once a layer and no inference K2; the loss falls every step.
    Returns (state, counts)."""
    zero_train_counts()
    losses, walls = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    counts = train_counts()
    want = {"encoder_attention": 0,
            "encoder_attention_fwd_res": n * layers * (2 if remat else 1),
            "encoder_attention_bwd_dkv": n * layers,
            "encoder_attention_bwd_dq": n * layers}
    check(counts == want, f"{tag}: launches {counts}, want {want}")
    check(all(math.isfinite(x) for x in losses)
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"{tag}: the loss did not fall every step: {losses}")
    print(f"[TRAIN] {tag}: {n} AdamW steps, loss "
          f"{' -> '.join(f'{x:.5f}' for x in losses)}; step wall p50 "
          f"{float(np.median(walls)):.1f} ms (each {', '.join(f'{w:.1f}' for w in walls)})"
          f"; launches a step: K2 with lse {counts['encoder_attention_fwd_res'] // n}, "
          f"dkv {counts['encoder_attention_bwd_dkv'] // n}, dq "
          f"{counts['encoder_attention_bwd_dq'] // n}; {smi}", flush=True)
    return state, counts


class Depth:
    """The model with its encoder cut to its first ``depth`` layers inside
    the ``with`` block."""

    def __init__(self, model, depth: int):
        self.enc, self.depth = model.encoder, depth

    def __enter__(self):
        self.layers = self.enc.layers
        self.enc.layers = torch.nn.ModuleList(self.layers[: self.depth])

    def __exit__(self, *exc):
        self.enc.layers = self.layers


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def phase_train(smi: str) -> dict:
    """[TRAIN] The training path at large-v3-turbo's full width (random f32
    weights from a seeded generator, synthetic batches of ``train_batch``).

    Arm A, ``run_finetune.py``'s defaults: 10 s windows (the position table
    cut to 500 rows), batch 8, 128 tokens, f32, no remat. One step's
    gradients with the kernels against the same step with the plain
    attention under autograd (relative L2 by group at most 1e-4), then four
    AdamW steps (lr 1e-5, weight decay 0.01) whose loss must fall every
    step. The weights then go through ``save_hf_checkpoint`` (the stdlib
    writer) and back through ``load_checkpoint`` (the stdlib reader where
    ``safetensors`` is absent): every tensor bit-equal, and one greedy 10 s
    window the same tokens from both models.
    Arm C: bf16 compute over those f32 weights at arm A's shapes: each
    group's gradient distance from the f32 gradients at most ``F32_RATIO``
    times that of the same bf16 step with the plain attention; then
    ``ARM_C_STEPS`` steps, each timed, each launching the backward kernels
    once a layer.
    Distillation: a two-layer layer-skip student of a fresh turbo model
    (``run_distill.py``'s defaults: lr 1e-4, temperature 1), three steps on
    arm A's batch: the KL falls and greedy agreement rises or holds. (From
    arm A's briefly fine-tuned weights, Adam's first steps at lr 1e-4 move
    the student's argmax erratically: agreement 0.3838 -> 0.0000 on the
    card while the KL fell.)
    Arm B: 30 s windows, batch 4, ``remat=True``, on that fresh model:
    at encoder depth 4, gradients with remat equal those without to 1e-5
    and the kernels' those of the plain attention to 1e-4 (at depth 32 the
    plain attention's probabilities would take about 23 GB); then two steps
    at depth 32 whose loss falls.
    Returns the counts of arm A's four steps."""
    dev = torch.device("cuda", 0)
    turbo = ARCH_PRESETS["large-v3-turbo"]
    arch = dataclasses.replace(turbo, max_source_positions=500,
                               alignment_heads=((2, 4), (3, 3)))
    layers = arch.encoder_layers
    model = init_params(arch, torch.Generator(device=dev).manual_seed(12),
                        device=dev).requires_grad_(True)
    batch = train_batch(arch, 8, 10, seed=3)
    torch.cuda.reset_peak_memory_stats()
    loss_k, g_k = grads(model, batch)
    loss_p, g_p = grads(model, batch, attention=attn.encoder_attention_plain)
    dist = group_l2(g_k, g_p)
    print(f"[TRAIN] arm A (B=8 x 10 s, f32): loss {loss_k:.6f} with the kernels, "
          f"{loss_p:.6f} with the plain attention; gradients, relative L2 by "
          f"group: {shown(dist)}", flush=True)
    check(max(dist.values()) <= 1e-4, f"arm A kernel vs plain gradients {dist}")
    del g_k, g_p
    state, tx = train.init_train_state(model)
    state, counts = train_steps("arm A (B=8 x 10 s, f32)", state,
                                train.make_train_step(tx), batch, 4, layers,
                                False, smi)
    print(f"[TRAIN] arm A peak device memory {peak_gib():.2f} GiB", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_hf_checkpoint(model, arch, tmp, chunk_length_s=10)
        t1 = time.perf_counter()
        loaded, _ = load_checkpoint(tmp, chunk_length_s=10)
        t2 = time.perf_counter()
    sd, ref = loaded.state_dict(), model.state_dict()
    check(sd.keys() == ref.keys() and all(torch.equal(sd[n], ref[n]) for n in sd),
          "checkpoint round trip not bit-equal")
    opts = GenerationOptions(language="en", max_new_tokens=32)
    audio = synth_audio(10, seed=7)[None]
    tokens = [WhisperEngine(m).transcribe_audio(audio, opts).tokens
              for m in (model, loaded)]
    check(np.array_equal(*tokens), "reloaded checkpoint decodes other tokens")
    print(f"[TRAIN] checkpoint of arm A: written in {t1 - t0:.2f} s, read "
          f"back with the stdlib reader in {t2 - t1:.2f} s; {len(sd)} tensors "
          f"bit-equal; "
          f"a greedy 10 s window {tokens[0].shape[1]} tokens, identical", flush=True)
    del loaded, sd, ref

    torch.cuda.reset_peak_memory_stats()
    _, g32 = grads(model, batch)
    loss16, g16 = grads(model, batch, compute_dtype=torch.bfloat16)
    _, g16p = grads(model, batch, compute_dtype=torch.bfloat16,
                    attention=attn.encoder_attention_plain)
    ratio = group_l2(g16, g32, g16p)
    print(f"[TRAIN] arm C (bf16 compute, f32 weights, B=8 x 10 s): loss "
          f"{loss16:.6f}; distance from the f32 gradients over the plain "
          f"attention's, by group: {shown(ratio, '.3f')}; distance from f32: "
          f"{shown(group_l2(g16, g32))}", flush=True)
    check(max(ratio.values()) <= F32_RATIO, f"arm C ratios {ratio}")
    del g32, g16, g16p
    zero_train_counts()
    step16 = train.make_train_step(tx, compute_dtype=torch.bfloat16)
    losses, walls = [], []
    for _ in range(ARM_C_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step16(state, batch)
        losses.append(loss.item())
        walls.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(x) for x in losses) and train_counts()["encoder_attention_bwd_dq"]
          == ARM_C_STEPS * layers, "arm C steps")
    print(f"[TRAIN] arm C steps (bf16 compute, B=8 x 10 s): loss "
          f"{' -> '.join(f'{x:.6f}' for x in losses)}; step wall p50 "
          f"{float(np.median(walls)):.1f} ms (each {', '.join(f'{w:.1f}' for w in walls)}); "
          f"peak device memory {peak_gib():.2f} GiB; {smi}", flush=True)

    del model, state, tx
    torch.cuda.empty_cache()

    model = init_params(turbo, torch.Generator(device=dev).manual_seed(13),
                        device=dev).requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    student = make_layer_skip_draft(model, 2)
    agree0 = distill.greedy_agreement(student, model, batch).item()
    dstate, dtx = distill.init_distill_state(student)
    step = distill.make_distill_step(dtx, temperature=1.0)
    kls = []
    for _ in range(3):
        dstate, kl = step(dstate, model, batch)
        kls.append(kl.item())
    agree1 = distill.greedy_agreement(dstate.student, model, batch).item()
    print(f"[TRAIN] distillation (2-layer layer-skip student, B=8 x 10 s): KL "
          f"{' -> '.join(f'{x:.5f}' for x in kls)}; greedy agreement "
          f"{agree0:.4f} -> {agree1:.4f}; peak device memory {peak_gib():.2f} GiB",
          flush=True)
    check(kls[-1] < kls[0] and agree1 >= agree0, "distillation did not improve")
    del student, dstate, dtx, batch
    torch.cuda.empty_cache()

    batch = train_batch(turbo, 4, 30, seed=4)
    torch.cuda.reset_peak_memory_stats()
    with Depth(model, 4):
        _, g0 = grads(model, batch)
        _, g1 = grads(model, batch, remat=True)
        _, gp = grads(model, batch, attention=attn.encoder_attention_plain)
    remat_d, plain_d = group_l2(g1, g0), group_l2(g0, gp)
    print(f"[TRAIN] arm B at encoder depth 4 (B=4 x 30 s): remat vs not, "
          f"relative L2 by group: {shown(remat_d)}; kernels vs plain: "
          f"{shown(plain_d)}", flush=True)
    check(max(remat_d.values()) <= 1e-5, f"arm B remat gradients {remat_d}")
    check(max(plain_d.values()) <= 1e-4, f"arm B kernel vs plain {plain_d}")
    del g0, g1, gp
    torch.cuda.reset_peak_memory_stats()
    state, tx = train.init_train_state(model)
    train_steps("arm B (B=4 x 30 s, f32, remat)", state,
                train.make_train_step(tx, remat=True), batch, 2, layers, True, smi)
    print(f"[TRAIN] arm B peak device memory {peak_gib():.2f} GiB", flush=True)
    del model, state, tx, batch
    torch.cuda.empty_cache()
    return counts


def phase_mesh(smi: str) -> None:
    """[MESH] (see the module docstring): the children are
    ``parallel.dryrun.card_nccl_graphs`` and ``card_gloo_pair``; a
    child's failure fails the phase."""
    from thewhisper_tpu_torch.parallel import dryrun
    from thewhisper_tpu_torch.parallel.launch import spawn

    print("[MESH] rule by backend: an NCCL mesh replays CUDA graphs of its "
          "decode loop, all-reduces captured; a gloo mesh runs its loop "
          "eagerly (gloo collectives cannot be captured)", flush=True)
    t0 = time.perf_counter()
    # K2 at the local head counts of tp 2 and 4, on (B, S, H, 64) views of
    # (B, S, H * 64) projections, as a sharded encoder layer gives it; the
    # tolerances of [K2].
    shown = []
    for heads in (10, 5):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(heads)
            q, k, v = (torch.randn(2, 1500, heads * 64, generator=g,
                                   device="cuda").to(dtype)
                       .view(2, 1500, heads, 64) for _ in range(3))
            out = attn.encoder_attention(q, k, v).float()
            err = (out - attn.encoder_attention_plain(q, k, v).float()
                   ).abs().max().item()
            if dtype == torch.float32:
                check(err <= 1e-4, f"K2 f32 err {err} at {heads} heads")
            else:
                err /= out.abs().max().item()
                check(err <= 2e-2, f"K2 bf16 rel err {err} at {heads} heads")
            shown.append(f"{heads} heads {str(dtype)[6:]} {err:.2e}")
    print(f"[MESH] K2 on (2, 1500, H, 64) views of the sharded projections: "
          f"{', '.join(shown)} (f32 max abs, bf16 relative)", flush=True)
    (a,) = spawn(dryrun.card_nccl_graphs, 1, backend="nccl", device="cuda",
                 timeout_s=300)
    check(a["same"]["tokens"] and a["same"]["num_generated"],
          f"(a) tokens differ: {a['same']}")
    print(f"[MESH] (a) NCCL dp 1 x tp 1, bf16 turbo, 30 s, CUDA graphs: "
          f"bit-identical to the unsharded engine {a['same']}; "
          f"{a['counts']['captured_all_reduces']} all-reduces captured, "
          f"{a['counts']['all_reduces']} issued in all; decode steps "
          f"{a['steps']}, generated {a['generated']}; wall "
          f"{a['wall'] * 1e3:.1f} ms meshed, {a['unsharded_wall'] * 1e3:.1f} "
          f"ms unsharded ({smi}); {time.perf_counter() - t0:.1f} s",
          flush=True)
    t1 = time.perf_counter()
    b = spawn(dryrun.card_gloo_pair, 2, backend="gloo", device="cuda",
              timeout_s=600)
    lead = b[0]
    for r in b:
        for name, c in r["counts"].items():
            tp = 2 if "tp2" in name else 1
            check(c["K1"] > 0 and c["K2"] > 0,
                  f"(b) rank {r['rank']} {name}: K1/K2 not launched {c}")
            check(r["heads"][name] == 20 // tp,
                  f"(b) rank {r['rank']} {name}: {r['heads'][name]} heads")
    for name, wall in lead["walls"].items():
        print(f"[MESH] (b) {name}: wall {wall * 1e3:.1f} ms, host-staged gloo "
              f"with two ranks on one card, a correctness check that "
              f"measures no deployment ({smi})", flush=True)
    print(f"[MESH] (b) f32 tokens and num_generated equal to the unsharded "
          f"engine's at dp 1 x tp 2 {lead['dp1xtp2 f32']} and dp 2 x tp 1 "
          f"{lead['dp2xtp1 f32']}; bf16 tp 2 prefill logits, relative L2: "
          f"{lead['bf16_logits']} (at most 1.5x the unsharded bf16's "
          f"distance from f32); bf16 tp 2 tokens agreeing with the "
          f"unsharded bf16 engine's for {lead['bf16_prefix']['agreeing']} "
          f"of {lead['bf16_prefix']['of']} new tokens", flush=True)
    print(f"[MESH] (c) dp 2 coalescer, three requests (en, de, fr): text "
          f"equal to the unsharded pipeline's, {len(lead['text'])} rows "
          f"({sum(len(t.split()) for t in lead['text'])} words); "
          f"{time.perf_counter() - t1:.1f} s", flush=True)


# [MESH_TRAIN] the (dp, tp) mesh for training and the sequence-parallel
# encoder

# K2 with S_q != S_k: (B, S_q, S_k, valid_len), H = 20. The first three are
# a 30 s encoder's rows split over tp 2, 4 and 8; the last the tiny
# encoder's 50 positions over tp 4 (13 rows a rank, the keys padded to 52).
SP_K2_CASES = ((2, 750, 1500, None), (2, 375, 1500, None),
               (2, 188, 1500, None), (2, 13, 52, 50))


def k2_uneven_rows(smi: str) -> dict:
    """K2 alone with S_q != S_k (``SP_K2_CASES``, f32 and bf16) against its
    plain version, [K2]'s tolerances (f32 max abs 1e-4, bf16 max abs over
    the output's max 2e-2), on the layout the sequence-parallel encoder
    gives it: k and v views of one gathered (2, B, S_k, H, 64) tensor.
    Each case's time beside the square K2's (S_k queries over the same
    keys) and the plain version's; bound from the case's operations (f32
    at the CUDA cores' rate, as [K2]'s f32 bound) and bytes."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(24)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s_q, s_k, valid in SP_K2_CASES:
            q = torch.randn(b, s_q, 20 * 64, generator=g, device=dev).to(
                dtype).view(b, s_q, 20, 64)
            kv = torch.randn(2, b, s_k, 20 * 64, generator=g, device=dev).to(
                dtype).view(2, b, s_k, 20, 64)
            k, v = kv[0], kv[1]
            out = attn.encoder_attention(q, k, v, valid)
            ref = attn.encoder_attention_plain(q, k, v, valid)
            err = (out.float() - ref.float()).abs().max().item()
            if dtype == torch.float32:
                check(err <= 1e-4, f"K2 f32 S_q {s_q} over {s_k}: err {err}")
            else:
                err /= out.float().abs().max().item()
                check(err <= 2e-2, f"K2 bf16 S_q {s_q} over {s_k}: rel err {err}")
            square = torch.randn(b, s_k, 20, 64, generator=g, device=dev).to(dtype)
            ms = cuda_ms(lambda: attn.encoder_attention(q, k, v, valid))
            square_ms = cuda_ms(lambda: attn.encoder_attention(square, k, v, valid))
            plain_ms = cuda_ms(lambda: attn.encoder_attention_plain(q, k, v, valid))
            flops = 4 * b * 20 * s_q * (valid or s_k) * 64
            peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
            case = {"dtype": str(dtype)[6:], "b": b, "s_q": s_q, "s_k": s_k,
                    "valid_len": valid, "max_abs_err": err, "ms": ms,
                    "square_ms": square_ms, "plain_ms": plain_ms,
                    **bound(nbytes(q, k, v, out), flops, peak)}
            cases.append(case)
            print(f"[MESH_TRAIN] K2 {case['dtype']:>8} B={b} S_q={s_q} over "
                  f"S_k={s_k} valid={valid}: {'max abs' if dtype == torch.float32 else 'rel'} "
                  f"err {err:.3e}; kernel {ms:.4f} ms, the square K2 ({s_k} "
                  f"queries) {square_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{case['bound_ms']:.4f} ms ({case['bound_by']}); {smi}",
                  flush=True)
            del q, kv, k, v, out, ref, square
    return {"cases": cases}


def phase_mesh_train(smi: str) -> dict:
    """[MESH_TRAIN] (see the module docstring). The parent builds the
    kernels (``phase_build``), checks K2 with S_q != S_k
    (:func:`k2_uneven_rows`) and computes every unsharded reference on the
    card (``parallel.dryrun.mesh_train_reference``: its f32 gradients
    written under a temporary directory of the checkout for the gloo
    ranks), frees it, then spawns the children,
    ``parallel.dryrun.card_train_nccl`` and ``card_train_gloo_pair``; a
    child's failure or a mismatch fails the phase. The ``run_finetune``
    CLI itself does not run here: the card machine has no
    ``transformers``, so it finds no tokenizer and exits; the phase drives
    the training calls the CLI makes (``shard_params``,
    ``init_train_state``, ``make_train_step(mesh=)``, ``place_batch``'s
    rows, K1 on each rank's rows), and the CLI's mesh flags are held on
    the CPU by ``tests/test_torch_parallel_train.py``. Returns K2's
    S_q != S_k cases for the kernels line."""
    from thewhisper_tpu_torch.parallel import dryrun
    from thewhisper_tpu_torch.parallel.launch import spawn

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    k2 = k2_uneven_rows(smi)
    arch, layers = dryrun.TRAIN_CARD_ARCH, dryrun.TRAIN_CARD_ARCH.encoder_layers
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="mesh_train_") as tmp:
        path = str(Path(tmp) / "grads.pt")
        ref = dryrun.mesh_train_reference(path)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        (a,) = spawn(dryrun.card_train_nccl, 1, ref["a"], backend="nccl",
                     device="cuda", timeout_s=300)
        t2 = time.perf_counter()
        pair = spawn(dryrun.card_train_gloo_pair, 2, path, ref, backend="gloo",
                     device="cuda", timeout_s=600)
        t3 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    dryrun.check_mesh_train(a, pair)
    want = {"K2-fwd-res": 3 * layers, "K2-dkv": 2 * layers, "K2-dq": 2 * layers}
    got = {k: a["counts"][k] for k in want}
    check(got == want, f"(a) launches {got}, want {want}")
    check(a["heads"] == arch.encoder_heads, f"(a) {a['heads']} heads")
    report_mesh_train(ref, a, pair, smi, (t0, t1, t2, t3))
    return k2


def report_mesh_train(ref, a, pair, smi: str, times) -> None:
    """[MESH_TRAIN]'s lines: the references, (a), (b) and (c)."""
    from thewhisper_tpu_torch.parallel import dryrun

    t0, t1, t2, t3 = times
    layers = dryrun.TRAIN_CARD_ARCH.encoder_layers
    walls = lambda steps: ", ".join(                       # noqa: E731
        f"{s['wall'] * 1e3:.1f} ms (peak {s['peak_gib']:.2f} GiB)" for s in steps)
    print(f"[MESH_TRAIN] large-v3-turbo at full width, the encoder cut to "
          f"{layers} layers, random f32 weights and biases (seed 0), TF32 off, "
          f"10 s through K1, {dryrun.CARD_TRAIN_TOKENS} tokens, a 4-token "
          f"prompt and every row padded to its own length", flush=True)
    print(f"[MESH_TRAIN] unsharded references on the card: (a) two steps "
          f"(the second remat) {walls(ref['a'])}; (b) the f32 step at batch 4 "
          f"{walls([ref['b']['f32']])}, loss {ref['b']['f32']['loss']:.6f}, bf16 "
          f"compute {walls([ref['b']['bf16']])}, its gradients "
          f"{ref['b']['bf16_vs_f32']:.3e} from f32 (relative L2); (c) the 30 s "
          f"encoder at B = {dryrun.CARD_SP_ROWS}, {dryrun.CARD_ARCH.encoder_layers} layers, f32 "
          f"{walls([ref['c']['f32']])}, bf16 {walls([ref['c']['bf16']])}, bf16 "
          f"{ref['c']['bf16_vs_f32']:.3e} from f32; {smi}; {t1 - t0:.1f} s",
          flush=True)
    losses = " then ".join(f"{s['loss']:.6f}" for s in a["steps"])
    print(f"[MESH_TRAIN] (a) NCCL dp 1 x tp 1: loss {losses}, all "
          f"{a['leaves']} gradient leaves and updated parameters of both steps "
          f"bit-identical to make_train_step on the unsharded model; launches "
          f"{a['counts']}, {a['heads']} heads; meshed step walls "
          f"{walls(a['steps'])} ({smi}); {t2 - t1:.1f} s", flush=True)
    lead = pair[0]
    for name, r in lead["arms"].items():
        ranks = [p["arms"][name] for p in pair]
        line = (f"[MESH_TRAIN] (b) {name}: loss {r['loss']:.6f} (unsharded "
                f"{ref['b']['bf16' if 'bf16' in name else 'f32']['loss']:.6f})")
        if "bf16" in name:
            line += (f", gradients {r['all_leaves']:.3e} from the unsharded f32 "
                     f"step's (the unsharded bf16 step's {ref['b']['bf16_vs_f32']:.3e}, "
                     f"bound {dryrun.BF16_RATIO}x), master weights f32")
        else:
            line += (f", worst gradient leaf {r['worst_leaf'][0]:.3e} "
                     f"({r['worst_leaf'][1]}), all leaves {r['all_leaves']:.3e} "
                     f"(bound {dryrun.CARD_GRAD_REL} a leaf)")
        launched = [tuple(x["counts"][k] for k in ("K2-fwd-res", "K2-dkv", "K2-dq"))
                    for x in ranks]
        step_walls = ", ".join(f"{x['wall'] * 1e3:.1f} ms" for x in ranks)
        peaks = ", ".join(f"{x['peak_gib']:.2f} GiB" for x in ranks)
        line += (f"; per rank: K2-fwd-res/dkv/dq {launched}, local heads "
                 f"{[x['heads'] for x in ranks]}; step wall {step_walls}, peak "
                 f"{peaks}: host-staged gloo with two ranks on one card, a "
                 f"correctness check that measures no deployment ({smi})")
        print(line, flush=True)
    print("[MESH_TRAIN] (b) replicated leaves and their gradients bit-identical "
          "on both tp ranks of every tp-2 arm; every parameter bit-identical on "
          "both dp ranks of dp 2 x tp 1", flush=True)
    for name, r in lead["sp"].items():
        print(f"[MESH_TRAIN] (c) SP tp 2 {name}, 30 s, B = {dryrun.CARD_SP_ROWS}: "
              f"{r['rows']} of {r['of']} queries a rank over {r['of']} keys, K2 "
              f"{r['K2']} launches a rank; {r['vs_f32']:.3e} from the unsharded "
              f"f32 encoder (bound {r['bound']:.3e})"
              + (f", {r['vs_unsharded_bf16']:.3e} from the unsharded bf16 one"
                 if "vs_unsharded_bf16" in r else "")
              + f"; wall {r['wall'] * 1e3:.1f} ms, peak {r['peak_gib']:.2f} GiB "
              f"(rank 0; host-staged gloo on one card, no deployment; {smi})",
              flush=True)
    print(f"[MESH_TRAIN] gloo children {t3 - t2:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def result_line(kind: str) -> str:
    """The last line. ``count`` is the number of cards the run used: one,
    whatever ``torch.cuda.device_count()`` shows."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}})


def main() -> None:
    smi = phase_device()
    phase_build()
    k1 = phase_logmel()
    k2 = phase_attention()
    launches, turbo = phase_main_path()
    phase_asr(turbo, smi)
    phase_graph(turbo, smi)
    phase_beam(turbo, smi)
    phase_longform(turbo, smi, quantized=False)
    phase_profile_shares(turbo, smi)
    torch.cuda.empty_cache()
    turbo_s = phase_turbo_s(turbo, smi)
    arms = phase_longform(turbo, smi, quantized=True)
    phase_profile_longform(arms, smi)
    del arms
    phase_stream(turbo_s, smi)
    phase_server(turbo_s, smi)
    phase_padded_rows(turbo_s, smi)
    del turbo, turbo_s
    torch.cuda.empty_cache()
    phase_small_reference()
    model, encs, k3_launches = phase_s_path()
    k3 = phase_mega(model, encs)
    k4 = phase_verify(model, encs[30])
    k4_launches = phase_spec(model, smi)
    q4_launches, q4_entry, s4_model = phase_s4(model, smi)
    phase_profile_s4(s4_model, smi)
    del model, encs, s4_model
    torch.cuda.empty_cache()
    p1 = phase_control(smi)
    p2, p3 = phase_mlp(smi)
    p4, p5 = phase_cache_writes(smi)
    probe_launches = phase_probes()
    k2_bwd = phase_attention_backward(smi)
    train_launches = phase_train(smi)
    phase_mesh(smi)
    k2_sp = phase_mesh_train(smi)
    kernels = [
        {"name": "logmel", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/logmel.cu",
         "replaces": "thewhisper_tpu/ops/logmel_pallas.py:113",
         "launches": launches["logmel"], **k1},
        {"name": "encoder_attention", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "thewhisper_tpu/models/whisper.py:189",
         "launches": launches["encoder_attention"], **k2,
         "sq_ne_sk": k2_sp},
        {"name": "mega_step", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/mega_step.cu",
         "replaces": "thewhisper_tpu/ops/mega_step.py:602",
         "launches": k3_launches, **k3},
        {"name": "mega_verify", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/mega_verify.cu",
         "replaces": "thewhisper_tpu/ops/mega_step.py:1061",
         "launches": k4_launches, **k4},
        {"name": "attention_control", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/attention_control.cu",
         "replaces": "tools/attention_probe.py:112",
         "launches": probe_launches["attention_control"], **p1},
        {"name": "mlp_chain", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/mlp_chain.cu",
         "replaces": "tools/gemv_chain_probe.py:150",
         "launches": probe_launches["mlp_chain"], **p2},
        {"name": "mlp_layer", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/mlp_chain.cu",
         "replaces": "tools/gemv_chain_probe.py:259",
         "launches": probe_launches["mlp_layer"], **p3},
        {"name": "write_row", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/cache_write.cu",
         "replaces": "tools/mega_caps_probe.py:74",
         "launches": probe_launches["write_row"], **p4},
        {"name": "write_column", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/cache_write.cu",
         "replaces": "tools/cache_write_probe.py:127",
         "launches": probe_launches["write_column"], **p5},
        {"name": "int4_linear", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/int4_linear.cu",
         "replaces": "thewhisper_tpu/models/whisper.py:110",
         "replaces_note": "no Pallas kernel: JAX's XLA fusion in _linear, "
                          "thewhisper_tpu/models/whisper.py:110-123",
         "launches": q4_launches, **q4_entry},
        {"name": "encoder_attention_fwd_res", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:234",
         "launches": train_launches["encoder_attention_fwd_res"], **k2_bwd["fwd_res"]},
        {"name": "encoder_attention_bwd_dkv", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/encoder_attention_bwd.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
         "launches": train_launches["encoder_attention_bwd_dkv"], **k2_bwd["dkv"]},
        {"name": "encoder_attention_bwd_dq", "route": "cuda",
         "source": "thewhisper_tpu_torch/csrc/encoder_attention_bwd.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
         "launches": train_launches["encoder_attention_bwd_dq"], **k2_bwd["dq"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(result_line(torch.cuda.get_device_name(0)))


if __name__ == "__main__":
    main()
