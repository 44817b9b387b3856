"""WhisperEngine: features or audio in, decoded tokens out (port of
thewhisper_tpu's ``engine/engine.py``).

A call pads its batch up to a bucket (``batch_buckets``, JAX's
``DEFAULT_BATCH_BUCKETS``), featurizes (the K1 kernel on the card),
encodes (K2 in every encoder layer), computes the cross K/V, prefills the
prompt and runs the greedy, sampled, beam or speculative loop
(``engine.decode``, ``engine.speculative``), then copies the result to
the host, cut back to the batch, as an :class:`EngineResult` with the JAX
engine's fields.

Every call is a dispatch and a decode, as in the JAX engine: the
``*_async`` entry points return a :class:`PendingResult` with the call's
featurizer and encoder queued on the device, and its ``result()`` decodes
(the synchronous entry points call it at once). A handle owns its encoder
states, and only its ``result()``, under the engine's lock, computes them
into its key's program, so handles in flight never share buffers. While
other handles are pending, a dispatch leaves its encoder to be queued by
the next ``result()``, behind that decode and the copy of its rows: the
card encodes the next call while the host unpacks, aligns and merges the
last. Audio, features and the long-form file may be host arrays (copied
through pinned memory without waiting for the queue) or tensors on the
engine's device. The offset entry points slice their windows from one
file on the device; a group (``transcribe_window_scan_async``,
``transcribe_batch_scan_async``) is those calls queued one after another
under one handle, where JAX compiles a scan.

The decode loop runs on a program kept for each static shape, keyed as
JAX's ``_jit_cache`` is (bucket, mel frames, prompt length, new tokens,
timestamps, beams; a sampled or speculative key adds whether it samples
and the speculative mode, "proposals", "ngram" or "draft"): its own self
cache (and a model draft's), cross K/V (computed into it layer by layer,
quantized there in the "S" modes, tiled per beam), tokens, alignment and
loop state. The engine keeps the programs :meth:`warmup` made and the
``MAX_PROGRAMS`` others used last, and frees the rest's buffers and
graphs. On the card every call replays a CUDA graph of its loop
(``engine.graphs``): ``STEPS_PER_CHECK`` greedy, sampled or beam steps or
``ROUNDS_PER_CHECK`` speculative rounds, captured at the key's first call
or by :meth:`WhisperEngine.warmup`, the host reading the stop flag
between replays; the encoder and the prefill stay eager. A capture that
fails raises. ``cuda_graphs=False`` runs the same steps eagerly, as a
CPU engine always does.

The "S" modes quantize the model (``models.quant``) and the cross K/V,
and a batch-1 bf16 "S" engine, at any decoder depth, decodes through the
K3 kernel (``ops.mega_step``), its position a device operand. With a
draft model, ngram drafting or proposal tokens a greedy call decodes
speculatively (``engine.speculative``; the verify rounds of a batch-1 "S"
call without timestamps run K4 at a device window position). Int4 is not
ported.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from thewhisper_tpu_torch.audio.features import (
    hann_window,
    log_mel_spectrogram,
    mel_filter_bank,
)
from thewhisper_tpu_torch.config import (
    HOP_LENGTH,
    GenerationOptions,
    LANGUAGES,
    SpecialTokens,
    WhisperArch,
)
from thewhisper_tpu_torch.engine.decode import (
    STEPS_PER_CHECK,
    BeamLoop,
    GreedyLoop,
    suppress_mask,
)
from thewhisper_tpu_torch.engine.graphs import StepGraph
from thewhisper_tpu_torch.engine.speculative import (
    ROUNDS_PER_CHECK,
    SpecLoop,
    load_draft,
    make_layer_skip_draft,
)
from thewhisper_tpu_torch.models.quant import (
    QuantizedKV,
    quantize_kv,
    quantize_params,
)
from thewhisper_tpu_torch.models.whisper import (
    Whisper,
    compute_cross_kv,
    cross_kv_layers,
    decoder_prefill,
    encoder_forward,
    fuse_self_qkv,
    make_cache,
)
from thewhisper_tpu_torch.ops.mega_step import mega_pays, pack_mega_params

# Batch sizes with a program of their own; a call is padded up to the
# nearest (the JAX engine's buckets).
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# Decode programs an engine keeps beside those its warmup made, the ones
# used last: every default bucket at one setting of the other keys, and one
# more.
MAX_PROGRAMS = 8


def _bucket_batch(b: int, buckets: Sequence[int]) -> int:
    for cand in buckets:
        if b <= cand:
            return cand
    return b


def _pad_batch(x: torch.Tensor, bb: int) -> torch.Tensor:
    """Zero rows up to ``bb`` along the batch axis, on x's device."""
    return torch.cat([x, x.new_zeros((bb - x.shape[0], *x.shape[1:]))])


def to_device(x, device, length: Optional[int] = None) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``. A host array goes to
    the card through pinned memory, queued on the current stream without
    waiting for the work queued there (a copy from pageable memory makes
    the host wait). ``length``: the first axis zero-padded to it. A tensor
    on another accelerator raises ``ValueError``: a call never carries on
    where its input does not lie."""
    device = torch.device(device)
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    if x.device.type != "cpu" and x.device != device:
        raise ValueError(f"input on {x.device}, the engine on {device}")
    if length is None and x.device == device:
        return x
    if device.type == "cuda" and x.device.type == "cpu":
        x = x.pin_memory()
    out = torch.zeros((x.shape[0] if length is None else length,
                       *x.shape[1:]), dtype=x.dtype, device=device)
    out[: x.shape[0]].copy_(x, non_blocking=True)
    return out


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host; from the card, into pinned memory,
    queued behind the stream's work (wait for it before reading)."""
    if not t.is_cuda:
        return t.to("cpu", copy=True)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def _greedy_only(name: str, options: GenerationOptions) -> None:
    if options.num_beams != 1 or options.temperature:
        raise ValueError(
            f"{name} is greedy-only (num_beams=1, temperature=0); use "
            "transcribe_audio for beam/sampled decoding")


class EngineResult(NamedTuple):
    """Host-side result of a transcription call (cut back to the batch)."""

    tokens: np.ndarray         # (B, P+max_new) int32
    num_generated: np.ndarray  # (B,)
    prompt_len: int
    sum_logprob: np.ndarray    # (B,)
    align: Optional[np.ndarray]  # (B, A, P+max_new, T_enc) or None
    decode_time_s: float
    token_logprobs: Optional[np.ndarray] = None  # (B, max_new)
    no_speech_prob: Optional[np.ndarray] = None  # (B,)
    spec_rounds: Optional[int] = None  # verify rounds run (speculative)
    # Step calls the greedy, sampled or beam loop ran (each one K3 launch
    # on the K3 route; up to STEPS_PER_CHECK - 1 of them after the stop,
    # which change nothing); None when speculative.
    decode_steps: Optional[int] = None


class PendingResult:
    """An engine call dispatched and not yet decoded (the JAX engine's
    ``PendingResult``): its audio or features on the device, its encoder
    queued or left for the next ``result()`` to queue (see the module
    docstring). :meth:`result` decodes it and returns what the synchronous
    call returns, ``decode_time_s`` counted from the dispatch; a second
    call returns the same result. :meth:`release` gives the call up and
    frees its tensors."""

    def __init__(self, engine: "WhisperEngine", x: torch.Tensor, audio: bool,
                 b: int, options: GenerationOptions, languages, t0: float,
                 draft_tokens=None, count: bool = True):
        self._engine = engine
        self._x, self._audio = x, audio      # (bb, N) audio or (bb, n_mels, T)
        self._enc: Optional[torch.Tensor] = None
        self.mel_frames = x.shape[-1] // HOP_LENGTH if audio else x.shape[-1]
        self.b, self.options, self.languages = b, options, languages
        self.draft_tokens = draft_tokens
        self.t0 = t0
        self.count = count    # adds its decode time to total_time_worked
        self._result: Optional[EngineResult] = None

    @property
    def queued(self) -> bool:
        """Whether its encoder is still to be queued."""
        return self._x is not None

    def encode(self) -> torch.Tensor:
        """The call's encoder states, queued now if they are not yet."""
        if self._x is not None:
            eng = self._engine
            with torch.inference_mode():
                mel = (log_mel_spectrogram(self._x, eng._mel_fb, eng._window)
                       if self._audio else self._x)
                self._enc = encoder_forward(eng.model, mel)
            self._x = None
        if self._enc is None:
            raise RuntimeError("this call was released")
        return self._enc

    def result(self, queue_next: bool = True) -> EngineResult:
        """``queue_next=False``: return without queueing the next pending
        call's encoder first (its launches fill the card's queue, and the
        host waits for them: a result wanted at once skips them)."""
        if self._result is None:
            self._result = self._engine._generate(self, queue_next)
            self._enc = None
        return self._result

    def release(self) -> None:
        self._engine._forget(self)
        self._x = self._enc = None


class PendingGroup:
    """Calls dispatched one after another under one handle: the GPU's form
    of JAX's window-scan programs. :meth:`result` decodes them in order and
    returns their rows stacked as one :class:`EngineResult` (the steps
    summed, ``decode_time_s`` from the first dispatch)."""

    def __init__(self, engine: "WhisperEngine", parts: List[PendingResult],
                 t0: float):
        self._engine, self._parts, self.t0 = engine, parts, t0
        self._result: Optional[EngineResult] = None

    def result(self) -> EngineResult:
        if self._result is None:
            try:
                rs = [p.result() for p in self._parts]
            except BaseException:
                self.release()
                raise
            dt = time.perf_counter() - self.t0
            self._engine.total_time_worked += dt

            def cat(name):
                if getattr(rs[0], name) is None:
                    return None
                return np.concatenate([getattr(r, name) for r in rs])

            self._result = EngineResult(
                tokens=cat("tokens"), num_generated=cat("num_generated"),
                prompt_len=rs[0].prompt_len, sum_logprob=cat("sum_logprob"),
                align=cat("align"), decode_time_s=dt,
                token_logprobs=cat("token_logprobs"),
                no_speech_prob=cat("no_speech_prob"),
                decode_steps=sum(r.decode_steps for r in rs))
        return self._result

    def release(self) -> None:
        for p in self._parts:
            p.release()


class _Program:
    """The decode loop of one static shape ``key`` = (bucket, mel frames,
    prompt length, new tokens, timestamps, beams), or that plus (sampled,
    speculative mode) for a sampled or speculative call, over ``t_enc``
    encoder frames: its buffers on the device and, once captured, the
    CUDA graph of ``per_check`` of its steps or rounds. A sampled program
    reads the call's temperature from a device scalar, so one graph
    serves every temperature of the fallback ladder.
    ``seconds`` and ``bytes``: the wall time to make it (buffers and
    capture) and the device memory it holds (its buffers, and the graph's
    private pool)."""

    def __init__(self, engine: "WhisperEngine", key: Tuple, t_enc: int):
        bb, _, p, max_new, timestamps, beams = key[:6]
        sampled, mode = key[6:] if len(key) > 6 else (False, None)
        self.key = key
        self.model = engine.model
        self.draft = engine.draft_model if mode == "draft" else None
        self.device = engine.device
        self.graph: Optional[StepGraph] = None
        arch = engine.arch
        rows = bb * beams

        def cross(a: WhisperArch, quantized: bool):
            shape = (a.decoder_layers, rows, a.decoder_heads, t_enc, a.head_dim)
            if quantized:
                return QuantizedKV(
                    torch.empty(shape, dtype=torch.int8, device=self.device),
                    torch.empty(shape[:3] + shape[4:], device=self.device))
            return torch.empty(shape, dtype=engine.compute_dtype,
                               device=self.device)

        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        a0 = torch.cuda.memory_allocated(self.device) if cuda else 0
        w = engine.spec_window
        slots = p + max_new + (w + 1 if mode else 0)
        q = engine.cross_kv_int8
        self.cache = make_cache(arch, rows, slots, cross(arch, q),
                                cross(arch, q), dtype=engine.compute_dtype)
        common = dict(suppress=engine._suppress,
                      begin_suppress=engine._begin_suppress,
                      capture_alignment=timestamps,
                      no_speech_id=engine.special.no_speech)
        self.per_check = ROUNDS_PER_CHECK if mode else STEPS_PER_CHECK
        self.temperature = (torch.ones((), device=self.device) if sampled
                            else 0.0)
        self.generator = torch.Generator(self.device) if sampled else None
        if mode:
            d_cache = None
            if self.draft is not None:
                d = self.draft.arch
                d_cache = make_cache(d, rows, slots, cross(d, False),
                                     cross(d, False))
            self.loop = SpecLoop(engine.model, self.draft, self.cache, d_cache,
                                 p, max_new, engine.special.eot, w,
                                 ngram_draft=mode == "ngram",
                                 proposals=mode == "proposals", **common)
        elif beams > 1:
            self.loop = BeamLoop(engine.model, self.cache, p, beams,
                                 max_new, engine.special.eot, **common)
        else:
            self.loop = GreedyLoop(engine.model, self.cache, p, max_new,
                                   engine.special.eot, **common)
        self.seconds = time.perf_counter() - t0
        self.bytes = (torch.cuda.memory_allocated(self.device) - a0
                      if cuda else 0)

    def load(self, enc: torch.Tensor) -> None:
        """Compute the call's cross K/V from the encoder states ``enc`` (B
        rows) into the program's, a layer at a time (quantized there in the
        "S" modes: ``quantize_kv`` reduces over frames alone, so a layer's
        scales are those of the whole stack), each row repeated for every
        beam (JAX's ``jnp.repeat`` on the batch axis); a model draft's from
        its own projections, in the compute type."""
        beams = self.key[5]
        for l, kv in enumerate(cross_kv_layers(self.model, enc)):
            for src, dst in zip(kv, (self.cache.cross_k, self.cache.cross_v)):
                if isinstance(dst, QuantizedKV):
                    src = quantize_kv(src)
                    pairs = ((src.q, dst.q[l]), (src.s, dst.s[l]))
                else:
                    pairs = ((src, dst[l]),)
                for a, b in pairs:
                    b.view(a.shape[0], beams, *b.shape[1:]).copy_(
                        a.unsqueeze(1))
        if self.draft is not None:
            dc = self.loop.draft_cache
            for l, (k, v) in enumerate(cross_kv_layers(self.draft, enc)):
                dc.cross_k[l].copy_(k)
                dc.cross_v[l].copy_(v)

    def capture(self, steps: Optional[int] = None) -> None:
        """Capture ``steps`` (``per_check``) step calls of the parked loop
        (every step a no-op until :meth:`decode` starts it), after one
        warm-up step; a sampled loop's graph registers its generator."""
        loop, kw = self.loop, self._step_args()
        steps = steps or self.per_check
        loop.park()
        t0 = time.perf_counter()
        gens = (self.generator,) if self.generator is not None else ()
        self.graph = StepGraph(lambda: loop.steps(steps, **kw),
                               lambda: loop.steps(1, **kw), self.device, *gens)
        self.seconds += time.perf_counter() - t0
        self.bytes += self.graph.bytes

    def _step_args(self) -> dict:
        if isinstance(self.loop, GreedyLoop):
            return {"temperature": self.temperature,
                    "generator": self.generator}
        return {}

    def decode(self, prompt: torch.Tensor, seed: int = 0,
               proposals: Optional[torch.Tensor] = None,
               temperature: float = 0.0):
        loop = self.loop
        if isinstance(loop, SpecLoop):
            loop.start(prompt, proposals)
        elif isinstance(loop, BeamLoop):
            loop.start(prompt)
        else:
            if self.generator is not None:
                self.generator.manual_seed(seed)
                self.temperature.fill_(temperature)
            loop.start(prompt, self.temperature, self.generator)
        replay = self.graph.replay if self.graph is not None else None
        loop.run(self.per_check, replay=replay, **self._step_args())
        return loop.result()


class WhisperEngine:
    """Whisper inference on one device (the model's).

    ``cross_kv_int8`` quantizes the cross K/V of every call
    (``models.quant.quantize_kv``). With it and ``megakernel``, a decoder
    where ``ops.mega_step.mega_pays`` gets its self q/k/v fused and K3's
    operands packed, in place (a no-op unless the decoder is weight-only
    int8), so batch-1 bf16 greedy steps run as one launch (K3) and so do
    speculative verify rounds (K4).

    ``draft_model`` (a decoder-only or full :class:`Whisper` with the
    target's vocab and width, e.g. ``engine.speculative
    .make_layer_skip_draft``) or ``spec_ngram`` make greedy calls
    speculative: ``spec_window`` drafted tokens a verify round, the output
    that of plain greedy. The draft's cross K/V come from this engine's
    encoder states through the draft's own projections, kept float in the
    compute type. ``draft_int8`` quantizes the draft's decoder (weight-only
    int8, in place; layers it shares with the target are copied first).

    Every call is padded up to the nearest of ``batch_buckets``, as JAX
    pads it (a speculative call's padded rows get zero proposals and cost
    rounds, as in JAX). On the card (``cuda_graphs``), every call replays
    a CUDA graph of ``STEPS_PER_CHECK`` decode steps (``ROUNDS_PER_CHECK``
    speculative rounds) for each static shape, captured at its first call
    or by :meth:`warmup`; ``cuda_graphs=False`` runs the same steps
    eagerly. The host reads the loop's stop flag once every
    ``STEPS_PER_CHECK`` steps (``ROUNDS_PER_CHECK`` rounds) either way,
    and the outputs do not depend on it. The device buffers and graph of
    each static shape stay with the engine for its next call of that
    shape, for the ``MAX_PROGRAMS`` shapes used last; making one more
    frees the least recently used."""

    def __init__(
        self,
        model: Whisper,
        special: Optional[SpecialTokens] = None,
        suppress_tokens: Sequence[int] = (),
        begin_suppress_tokens: Sequence[int] = (),
        cross_kv_int8: bool = False,
        megakernel: bool = True,
        draft_model: Optional[Whisper] = None,
        spec_window: int = 4,
        spec_ngram: bool = False,
        draft_int8: bool = False,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        cuda_graphs: bool = True,
    ):
        if spec_ngram and draft_model is not None:
            raise ValueError("pick one: a draft model or ngram drafting")
        if draft_model is not None:
            if draft_model.arch.vocab_size != model.arch.vocab_size:
                raise ValueError("draft vocab must match the target vocab")
            if draft_model.arch.d_model != model.arch.d_model:
                raise ValueError(
                    "draft d_model must match the target (the draft's "
                    "cross-KV is computed from the shared encoder's states)")
        self.cross_kv_int8 = cross_kv_int8
        if (cross_kv_int8 and megakernel and model.mega is None
                and mega_pays(model.arch)):
            pack_mega_params(fuse_self_qkv(model))
        if draft_model is not None:
            shared = any(a is b for a, b in zip(draft_model.decoder.layers,
                                                model.decoder.layers))
            if draft_int8:
                if shared and any(type(m) is nn.Linear for m in
                                  draft_model.decoder.layers.modules()):
                    # Quantizing in place must not touch the target's layers.
                    draft_model.decoder.layers = copy.deepcopy(
                        draft_model.decoder.layers)
                    shared = False
                quantize_params(draft_model, components=("decoder",))
            if not shared:
                fuse_self_qkv(draft_model)
        self.draft_model = draft_model
        self.spec_window = spec_window
        self.spec_ngram = bool(spec_ngram)
        self.model = model
        self.arch: WhisperArch = model.arch
        self.device = model.device
        self.compute_dtype = model.dtype
        self.special = special or SpecialTokens.for_vocab(self.arch.vocab_size)
        v = self.arch.vocab_size
        self._suppress = (
            torch.from_numpy(suppress_mask(v, suppress_tokens)).to(self.device)
            if len(suppress_tokens) else None)
        self._begin_suppress = (
            torch.from_numpy(suppress_mask(v, begin_suppress_tokens)).to(self.device)
            if len(begin_suppress_tokens) else None)
        self._mel_fb = torch.from_numpy(
            mel_filter_bank(num_mel_filters=self.arch.n_mels)).to(self.device)
        self._window = torch.from_numpy(hann_window()).to(self.device)
        # Wall-clock accumulator, as the JAX engine's total_time_worked.
        self.total_time_worked = 0.0
        self.batch_buckets = tuple(batch_buckets)
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        # The decode programs by static shape, the one used last at the end,
        # the keys warmup made (kept beyond MAX_PROGRAMS), and the lock that
        # keeps one call at a time on their buffers and on the list of
        # handles not yet decoded, in dispatch order.
        self._programs: "OrderedDict[Tuple, _Program]" = OrderedDict()
        self._warm_keys: set = set()
        self._lock = threading.Lock()
        self._pending: List[weakref.ref] = []
        self._prompts: dict = {}

    # -- prompt construction -------------------------------------------------

    def build_prompt(self, language: Optional[str], task: str = "transcribe") -> list:
        sp = self.special
        lang_id = sp.language_id(language or "en", LANGUAGES[: sp.n_languages])
        task_id = sp.transcribe if task == "transcribe" else sp.translate
        return [sp.sot, lang_id, task_id, sp.no_timestamps]

    def _prompt_rows(self, options: GenerationOptions, bb: int,
                     languages: Optional[Sequence[str]]) -> np.ndarray:
        """(bb, P) int32 prompt rows; per-sample languages override
        ``options.language`` row-wise."""
        base = np.asarray(
            self.build_prompt(options.language, options.task), np.int32)
        rows = np.tile(base, (bb, 1))
        if languages is not None and len(languages):
            for i, lang in enumerate(list(languages)[:bb]):
                rows[i] = self.build_prompt(str(lang), options.task)
        return rows

    # -- public API ----------------------------------------------------------

    def _on_device(self, x) -> torch.Tensor:
        """Audio or features, host or device, as f32 on the engine's device
        (see :func:`to_device`)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, dtype=np.float32)
        return to_device(x, self.device).float()

    def _features(self, mel) -> torch.Tensor:
        """(B, n_mels, T_mel) or (n_mels, T_mel) features, host or device,
        as a batched tensor on the engine's device."""
        mel = self._on_device(mel)
        return mel[None] if mel.ndim == 2 else mel

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        bb = _bucket_batch(x.shape[0], self.batch_buckets)
        return x if bb == x.shape[0] else _pad_batch(x, bb)

    def _spec_mode(self, options: GenerationOptions,
                   draft_tokens) -> Optional[str]:
        """How a call decodes speculatively ("proposals", "ngram" or
        "draft"), or None: only greedy calls do, with proposal tokens, an
        ngram engine or a draft model (proposals first)."""
        if options.num_beams != 1 or options.temperature:
            return None
        if draft_tokens is not None:
            return "proposals"
        if self.spec_ngram:
            return "ngram"
        return "draft" if self.draft_model is not None else None

    def _key(self, bb: int, mel_frames: int, p: int,
             options: GenerationOptions, mode: Optional[str]) -> Tuple:
        """A call's program key: JAX's ``_generate_fn`` key (bucket, mel
        frames, prompt length, new tokens, timestamps, beams), with whether
        it samples and its proposals flag (here the speculative mode) added
        where they are not False and None. JAX keys the temperature itself;
        here a sampled program reads it from the device, so the rungs of
        the fallback ladder share one program and its memory."""
        beams = options.num_beams
        sampled = beams == 1 and bool(options.temperature)
        key = (bb, mel_frames, p, options.max_new_tokens,
               bool(options.return_timestamps), beams)
        return key + (sampled, mode) if sampled or mode else key

    def _prep_proposals(self, draft_tokens, options: GenerationOptions,
                        b: int) -> Optional[torch.Tensor]:
        """Caller-supplied proposal tokens as (b, max_new) on the device,
        zero-padded or cut; None for beam or sampling calls (speculation
        is greedy-only)."""
        if (draft_tokens is None or options.num_beams != 1
                or options.temperature):
            return None
        dt = np.asarray(draft_tokens, np.int64)
        if dt.ndim == 1:
            dt = dt[None]
        max_new = options.max_new_tokens
        arr = np.zeros((b, max_new), np.int64)
        r, c = min(dt.shape[0], b), min(dt.shape[1], max_new)
        arr[:r, :c] = dt[:r, :c]
        return to_device(arr, self.device)

    def _device_prompt(self, options: GenerationOptions, bb: int,
                       languages) -> torch.Tensor:
        """(bb, P) prompt rows on the device, kept per (bucket, language,
        task, row languages) as JAX keeps them: no call waits on their
        upload."""
        langs = (tuple(str(l) for l in list(languages)[:bb])
                 if languages is not None and len(languages) else None)
        key = (bb, options.language, options.task, langs)
        rows = self._prompts.get(key)
        if rows is None:
            if len(self._prompts) >= 512:
                self._prompts.clear()
            rows = self._prompts[key] = to_device(
                self._prompt_rows(options, bb, languages).astype(np.int64),
                self.device)
        return rows

    def transcribe_features_async(self, mel, options: GenerationOptions,
                                  languages: Optional[Sequence[str]] = None,
                                  draft_tokens=None) -> PendingResult:
        """Dispatch without decoding; see :class:`PendingResult`."""
        t0 = time.perf_counter()
        mel = self._features(mel)
        b = mel.shape[0]
        return self._dispatch(self._padded(mel), False, b, options, languages,
                              t0, draft_tokens)

    def transcribe_features(
        self,
        mel,                                  # (B, n_mels, T_mel)
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
        draft_tokens=None,                    # (B, <= max_new) proposals
    ) -> EngineResult:
        return self.transcribe_features_async(
            mel, options, languages, draft_tokens).result()

    def transcribe_audio_async(self, audio, options: GenerationOptions,
                               languages: Optional[Sequence[str]] = None,
                               draft_tokens=None) -> PendingResult:
        """Dispatch without decoding; see :class:`PendingResult`."""
        t0 = time.perf_counter()
        x = self._on_device(audio)
        if x.ndim == 1:
            x = x[None]
        b = x.shape[0]
        # Padded before featurizing, as JAX pads.
        return self._dispatch(self._padded(x), True, b, options, languages,
                              t0, draft_tokens)

    def transcribe_audio(
        self,
        audio,                                # (B, n_samples) f32, padded
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
        draft_tokens=None,                    # (B, <= max_new) proposals
    ) -> EngineResult:
        """Raw audio (already padded to the chunk, ``n_samples % 160 == 0``;
        a host array or a tensor on the engine's device) -> features
        through the K1 kernel -> the decode of :meth:`transcribe_features`."""
        return self.transcribe_audio_async(
            audio, options, languages, draft_tokens).result()

    def _window_audio(self, full_audio, offsets: Sequence[int],
                      win_samples: int, bucket_samples: int) -> torch.Tensor:
        """(len(offsets), bucket_samples) f32 on the device: ``win_samples``
        of the file at each offset, gathered on the device in one call, then
        zero-padded to ``bucket_samples`` (never sliced long, which would let
        the next window's audio in where silence belongs)."""
        full = self._on_device(full_audio)
        offs = np.asarray([int(o) for o in offsets], np.int64)
        if full.ndim != 1 or bucket_samples < win_samples:
            raise ValueError("a (N,) file and bucket_samples >= win_samples")
        if offs.min() < 0 or offs.max() + win_samples > full.shape[0]:
            raise ValueError(
                f"windows of {win_samples} samples at offsets {offs.min()}.."
                f"{offs.max()} read past the {full.shape[0]}-sample file "
                "(pad it by a window)")
        idx = (to_device(offs, self.device)[:, None]
               + torch.arange(win_samples, device=self.device))
        wins = torch.take(full, idx)
        if bucket_samples != win_samples:
            wins = torch.nn.functional.pad(wins, (0, bucket_samples - win_samples))
        return wins

    def _windows(self, full_audio, offsets: Sequence[int], rows: int,
                 win_samples: int, bucket_samples: int,
                 options: GenerationOptions, languages, t0: float,
                 count: bool = True) -> PendingResult:
        """Dispatch ``offsets``' windows as one call of ``rows`` rows, the
        last offset repeated into the rows past them (real audio, so those
        rows stop when the last real row stops)."""
        offs = list(offsets) + [offsets[-1]] * (rows - len(offsets))
        x = self._window_audio(full_audio, offs, win_samples, bucket_samples)
        return self._dispatch(x, True, len(offsets), options, languages, t0,
                              count=count)

    def transcribe_window_async(
        self,
        full_audio,                           # (N,) the file, padded
        offset: int,
        win_samples: int,
        bucket_samples: int,
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
    ) -> PendingResult:
        """Dispatch one long-form window by its offset into the file, at
        batch 1 whatever the buckets (JAX's single-window program);
        greedy only."""
        _greedy_only("transcribe_window_async", options)
        return self._windows(full_audio, [offset], 1, win_samples,
                             bucket_samples, options, languages,
                             time.perf_counter())

    def transcribe_windows_async(
        self,
        full_audio,                           # (N,) the file, padded
        offsets: Sequence[int],
        win_samples: int,
        bucket_samples: int,
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
    ) -> PendingResult:
        """Dispatch a batch of long-form windows by offset, padded to its
        bucket by repeating the last offset; greedy only."""
        _greedy_only("transcribe_windows_async", options)
        rows = _bucket_batch(len(offsets), self.batch_buckets)
        return self._windows(full_audio, offsets, rows, win_samples,
                             bucket_samples, options, languages,
                             time.perf_counter())

    def _group(self, full_audio, chunks, rows: int, win_samples: int,
               bucket_samples: int, options: GenerationOptions,
               languages) -> PendingGroup:
        t0 = time.perf_counter()
        parts: List[PendingResult] = []
        try:
            for offs in chunks:
                parts.append(self._windows(
                    full_audio, offs, rows, win_samples, bucket_samples,
                    options, languages, t0, count=False))
        except BaseException:
            for p in parts:
                p.release()
            raise
        return PendingGroup(self, parts, t0)

    def _no_speculation(self, name: str, options: GenerationOptions) -> None:
        _greedy_only(name, options)
        if self.spec_ngram or self.draft_model is not None:
            raise ValueError(f"{name} does not support speculative engines; "
                             "dispatch per window instead")

    def transcribe_window_scan_async(
        self,
        full_audio,                           # (N,) the file, padded
        offsets: Sequence[int],
        n_windows: int,
        win_samples: int,
        bucket_samples: int,
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
    ) -> PendingGroup:
        """Up to ``n_windows`` long-form windows at batch 1, one after
        another under one handle (JAX's window-scan program; a short group
        runs only its windows, where JAX repeats the last and drops its
        rows); plain greedy only."""
        name = "transcribe_window_scan_async"
        self._no_speculation(name, options)
        if not 1 <= len(offsets) <= n_windows:
            raise ValueError(f"got {len(offsets)} offsets for a {n_windows}"
                             "-window scan program")
        return self._group(full_audio, [[o] for o in offsets], 1,
                           win_samples, bucket_samples, options, languages)

    def transcribe_batch_scan_async(
        self,
        full_audio,                           # (N,) the file, padded
        offsets: Sequence[int],               # n_groups * batch of them
        n_groups: int,
        batch: int,
        win_samples: int,
        bucket_samples: int,
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
    ) -> PendingGroup:
        """``n_groups`` full batches of ``batch`` long-form windows, one
        after another under one handle (JAX's batch-scan program, each
        group at exactly ``batch`` rows); plain greedy only."""
        name = "transcribe_batch_scan_async"
        self._no_speculation(name, options)
        if len(offsets) != n_groups * batch:
            raise ValueError(
                f"got {len(offsets)} offsets for a {n_groups}x{batch} "
                "batch-scan program (groups must be full)")
        chunks = [list(offsets[g * batch: (g + 1) * batch])
                  for g in range(n_groups)]
        return self._group(full_audio, chunks, batch, win_samples,
                           bucket_samples, options, languages)

    def _live(self) -> List[PendingResult]:
        """The handles not yet decoded, in dispatch order (under the lock)."""
        live = [r() for r in self._pending]
        live = [h for h in live if h is not None]
        self._pending = [weakref.ref(h) for h in live]
        return live

    def _dispatch(self, x: torch.Tensor, audio: bool, b: int,
                  options: GenerationOptions, languages, t0: float,
                  draft_tokens=None, count: bool = True) -> PendingResult:
        """A handle for ``x`` (bb rows: the call's ``b``, padded), its
        encoder queued now if no other handle is pending, else left for
        the next decode to queue."""
        if options.num_beams < 1:
            raise ValueError(f"num_beams {options.num_beams} < 1")
        handle = PendingResult(self, x, audio, b, options, languages, t0,
                               draft_tokens, count)
        with self._lock:
            idle = not self._live()
            self._pending.append(weakref.ref(handle))
        if idle:
            handle.encode()
        return handle

    def _forget(self, handle: PendingResult) -> None:
        with self._lock:
            self._pending = [r for r in self._pending if r() is not handle]

    def _generate(self, handle: PendingResult,
                  queue_next: bool = True) -> EngineResult:
        """Decode a dispatched call and return its first ``b`` rows on the
        host. Once its rows are queued for the copy, the encoder of the
        next handle still to be queued is queued behind them (unless
        ``queue_next`` is False)."""
        with self._lock:
            enc = handle.encode()
            res, p = self._decode_call(handle, enc)
            self._pending = [r for r in self._pending if r() is not handle]
            nxt = next((h for h in self._live() if h.queued and queue_next),
                       None)
            return self._unpack(res, handle.b, p, handle.options, handle.t0,
                                then=nxt.encode if nxt else None,
                                count=handle.count)

    def _decode_call(self, handle: PendingResult, enc: torch.Tensor):
        """The decode of ``handle``'s call on its encoder states ``enc``
        (bb rows) by its key's program. Returns (result on the device,
        prompt length)."""
        options = handle.options
        bb = enc.shape[0]
        props = self._prep_proposals(handle.draft_tokens, options, bb)
        prompt = self._device_prompt(options, bb, handle.languages)
        p = prompt.shape[1]
        key = self._key(bb, handle.mel_frames, p, options,
                        self._spec_mode(options, props))
        with torch.inference_mode():
            return self._decode(key, enc, prompt, options, props), p

    def _decode(self, key: Tuple, enc: torch.Tensor, prompt: torch.Tensor,
                options: GenerationOptions,
                proposals: Optional[torch.Tensor]):
        """The loop of ``key``'s program on this call's encoder states and
        prompt: a graph replayed where the engine takes graphs (captured
        now if the key has none yet), else eager steps. A new program frees
        the one used least recently of those ``warmup`` did not make, while
        they number ``MAX_PROGRAMS``."""
        prog = self._programs.pop(key, None)
        if prog is None:
            cold = [k for k in self._programs if k not in self._warm_keys]
            for k in cold[: max(0, len(cold) - MAX_PROGRAMS + 1)]:
                del self._programs[k]
            prog = _Program(self, key, enc.shape[1])
        self._programs[key] = prog
        prog.load(enc)
        if self.cuda_graphs and prog.graph is None:
            prog.capture()
        return prog.decode(prompt, options.seed, proposals,
                           float(options.temperature))

    def _unpack(self, res, b: int, p: int, options: GenerationOptions,
                t0: float, then=None, count: bool = True) -> EngineResult:
        """The first ``b`` rows of a decode result, copied to the host (on
        the CPU too: the rows may be a program's buffers, which its next
        call overwrites). ``then`` runs once the copies are queued, before
        the host waits for them."""
        fields = [res.tokens, res.num_generated, res.sum_logprob,
                  res.token_logprobs, res.no_speech_prob]
        if options.return_timestamps:
            # Shipped at compute precision, as the JAX engine does.
            fields.append(res.align.to(self.compute_dtype).float())
        out = [_to_host(t[:b]) for t in fields]
        copied = None
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record()
        if then is not None:
            then()
        if copied is not None:
            copied.synchronize()
        out = [t.numpy() for t in out]
        dt = time.perf_counter() - t0
        if count:
            self.total_time_worked += dt
        return EngineResult(
            tokens=out[0], num_generated=out[1], prompt_len=p,
            sum_logprob=out[2], align=out[5] if len(out) > 5 else None,
            decode_time_s=dt, token_logprobs=out[3], no_speech_prob=out[4],
            spec_rounds=getattr(res, "rounds", None),
            decode_steps=res.steps)

    def warmup(self, t_mel: int, batches: Sequence[int] = (1,),
               max_new_tokens: int = 128, timestamps: bool = True,
               num_beams: int = 1, proposals: bool = False) -> None:
        """Make the decode programs (on the card: capture their graphs) of
        the buckets of ``batches`` at ``t_mel`` mel frames, by one call of
        zeros each, so that a request of those shapes never pays a capture
        (JAX's ``warmup``, which compiles). ``proposals=True`` also makes
        the proposal-token programs (calls with ``draft_tokens``, the
        streaming path's cross-tick reuse) of a greedy warm-up. The engine
        keeps them whatever it makes after (``MAX_PROGRAMS`` bounds the
        others)."""
        for b in batches:
            opts = GenerationOptions(
                max_new_tokens=max_new_tokens, return_timestamps=timestamps,
                num_beams=num_beams)
            p = len(self.build_prompt(opts.language, opts.task))
            bb = _bucket_batch(b, self.batch_buckets)
            mel = np.zeros((b, self.arch.n_mels, t_mel), np.float32)
            drafts = [None]
            if proposals and self._spec_mode(opts, True) == "proposals":
                drafts.append(np.zeros((b, max_new_tokens), np.int64))
            for dt in drafts:
                self._warm_keys.add(
                    self._key(bb, t_mel, p, opts, self._spec_mode(opts, dt)))
                self.transcribe_features(mel, opts, draft_tokens=dt)

    def programs(self) -> list:
        """One dict a decode program, the one used last at the end: its
        key, the seconds and device bytes it took to make (buffers and
        graph capture), and whether it holds a graph."""
        return [{"key": key, "seconds": prog.seconds, "bytes": prog.bytes,
                 "graph": prog.graph is not None}
                for key, prog in self._programs.items()]

    def detect_language(self, mel) -> Tuple[np.ndarray, np.ndarray]:
        """Spoken language from features: one forced decoder pass from
        ``<|startoftranscript|>``, softmax over the language-token block.
        Returns (language codes (B,), probabilities (B,))."""
        mel = self._features(mel)
        b = mel.shape[0]
        mel = self._padded(mel)
        sp = self.special
        with torch.inference_mode():
            enc = encoder_forward(self.model, mel)
            ck, cv = compute_cross_kv(self.model, enc)
            cache = make_cache(self.arch, mel.shape[0], 4, ck, cv)
            sot = torch.full((mel.shape[0], 1), sp.sot, dtype=torch.long,
                             device=self.device)
            logits, _, _ = decoder_prefill(self.model, sot, cache)
            lang_logits = logits[:b, -1, sp.first_language:
                                 sp.first_language + sp.n_languages]
            probs = torch.softmax(lang_logits, dim=-1).cpu().numpy()
        idx = probs.argmax(-1)
        codes = np.asarray([LANGUAGES[i] for i in idx])
        return codes, probs[np.arange(b), idx]

    @staticmethod
    def from_checkpoint(
        path: str,
        chunk_length_s: float = 30.0,
        compute_dtype: torch.dtype = torch.bfloat16,
        position_mode: Optional[str] = None,
        device="cuda",
        quantize: Optional[str] = None,
        draft: Optional[str] = None,
        spec_window: int = 4,
    ) -> "WhisperEngine":
        """Build an engine from an HF checkpoint directory, with the
        suppress-token lists of its generation config.

        ``quantize`` selects an "S" mode, as in the JAX engine: ``"int8"``
        (weight-only int8 decoder and tied table), ``"int8-weights"`` (the
        table stays float), ``"int8-all"`` (``"int8"`` plus a W8A8
        encoder), ``"int4"`` ("S4": weight-only int4 decoder linears, run
        by the Q4 kernel on the card, and an int8 table); each also
        quantizes the cross K/V.

        ``draft`` makes greedy calls speculative: ``"ngram"`` (prompt
        lookup), ``"layer-skip:N"`` (the target's first N decoder layers,
        taken after quantization, so int4 in "S4"), a ``.npz`` written by
        either package's ``save_draft``, or another checkpoint directory
        (same width and vocab; its encoder is dropped). In every quantized
        mode a draft's float decoder becomes weight-only int8
        (``draft_int8``), "S4" included, as JAX quantizes it."""
        from thewhisper_tpu_torch.models.load import load_checkpoint

        modes = ("int8", "int8-weights", "int8-all", "int4")
        if quantize is not None and quantize not in modes:
            raise ValueError(f"unknown quantize mode: {quantize}")
        model, _ = load_checkpoint(
            path, dtype=compute_dtype, device=device,
            chunk_length_s=chunk_length_s, position_mode=position_mode)
        if quantize is not None:
            quantize_params(model, components=("decoder",),
                            quantize_embedding_table=quantize != "int8-weights",
                            bits=4 if quantize == "int4" else 8)
            if quantize == "int8-all":
                quantize_params(model, components=("encoder",),
                                activation_int8=True)
        draft_model = None
        if draft and draft != "ngram":
            if draft.startswith("layer-skip:"):
                draft_model = make_layer_skip_draft(
                    model, int(draft.split(":", 1)[1]))
            elif draft.endswith(".npz") or os.path.exists(draft + ".npz"):
                draft_model = load_draft(draft, dtype=compute_dtype,
                                         device=device)
            else:
                draft_model, _ = load_checkpoint(
                    draft, dtype=compute_dtype, device=device,
                    chunk_length_s=chunk_length_s,
                    position_mode=position_mode)
                draft_model.encoder = None
        suppress: Sequence[int] = ()
        begin: Sequence[int] = ()
        gen_path = os.path.join(path, "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                gc = json.load(f)
            suppress = gc.get("suppress_tokens", []) or []
            begin = gc.get("begin_suppress_tokens", []) or []
        return WhisperEngine(model, suppress_tokens=suppress,
                             begin_suppress_tokens=begin,
                             cross_kv_int8=quantize is not None,
                             draft_model=draft_model, spec_window=spec_window,
                             spec_ngram=draft == "ngram",
                             draft_int8=quantize is not None)
