"""WhisperEngine: features or audio in, decoded tokens out (port of
thewhisper_tpu's ``engine/engine.py``).

A call (a speculative one excepted) pads its batch up to a bucket
(``batch_buckets``, JAX's ``DEFAULT_BATCH_BUCKETS``), featurizes (the K1
kernel on the card), encodes (K2 in every encoder layer), computes the
cross K/V, prefills the
prompt and runs the greedy, sampled or beam loop (``engine.decode``), then
copies the result to the host, cut back to the batch, as an
:class:`EngineResult` with the JAX engine's fields.

The decode loop runs on a program kept for each static shape, keyed as
JAX's ``_jit_cache`` is (bucket, mel frames, prompt length, new tokens,
timestamps, beams): its own self cache, cross K/V (computed into it layer
by layer, quantized there in the "S" modes, tiled per beam), tokens,
alignment and loop state. The engine keeps the ``MAX_PROGRAMS`` programs
used last and frees the others' buffers and graphs. On the card a greedy
(temperature 0) or beam call replays a CUDA graph of ``STEPS_PER_CHECK``
steps (``engine.graphs``), captured at the key's first call or by
:meth:`WhisperEngine.warmup`, the host reading the stop flag between
replays; the encoder and the prefill stay eager. ``cuda_graphs=False``
runs the same steps eagerly, as a CPU engine always does, and so does a
sampled call (its generator stays eager).

The "S" modes quantize the model (``models.quant``) and the cross K/V,
and a batch-1 bf16 "S" engine, at any decoder depth, decodes through the
K3 kernel (``ops.mega_step``), its position a device operand. With a
draft model, ngram drafting or proposal tokens a greedy call decodes
speculatively and eagerly (``engine.speculative``; its batch-1 "S" verify
rounds run K4). Int4, the async handles and the window-scan programs are
not ported yet.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from thewhisper_tpu_torch.audio.features import (
    hann_window,
    log_mel_spectrogram,
    mel_filter_bank,
)
from thewhisper_tpu_torch.config import (
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
    load_draft,
    make_layer_skip_draft,
    speculative_decode,
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

# Decode programs an engine keeps, the ones used last: every default bucket
# at one setting of the other keys, as a server warms them, and one more.
MAX_PROGRAMS = 8


def _bucket_batch(b: int, buckets: Sequence[int]) -> int:
    for cand in buckets:
        if b <= cand:
            return cand
    return b


def _pad_batch(x: torch.Tensor, bb: int) -> torch.Tensor:
    """Zero rows up to ``bb`` along the batch axis, on x's device."""
    return torch.cat([x, x.new_zeros((bb - x.shape[0], *x.shape[1:]))])


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
    # Step calls the greedy or beam loop ran (each one K3 launch on the K3
    # route; up to STEPS_PER_CHECK - 1 of them after the stop, which change
    # nothing); None when speculative.
    decode_steps: Optional[int] = None


class _Program:
    """The decode loop of one static shape ``key`` = (bucket, mel frames,
    prompt length, new tokens, timestamps, beams) over ``t_enc`` encoder
    frames: its buffers on the device and, once captured, the CUDA graph of
    ``steps`` of its steps. ``seconds`` and ``bytes``: the wall time to make
    it (buffers and capture) and the device memory it holds (its buffers,
    and the graph's private pool)."""

    def __init__(self, engine: "WhisperEngine", key: Tuple, t_enc: int):
        bb, _, p, max_new, timestamps, beams = key
        self.key = key
        self.model = engine.model
        self.device = engine.device
        self.graph: Optional[StepGraph] = None
        arch = engine.arch
        rows = bb * beams
        shape = (arch.decoder_layers, rows, arch.decoder_heads, t_enc,
                 arch.head_dim)

        def cross():
            if engine.cross_kv_int8:
                return QuantizedKV(
                    torch.empty(shape, dtype=torch.int8, device=self.device),
                    torch.empty(shape[:3] + shape[4:], device=self.device))
            return torch.empty(shape, dtype=engine.compute_dtype,
                               device=self.device)

        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        a0 = torch.cuda.memory_allocated(self.device) if cuda else 0
        self.cache = make_cache(arch, rows, p + max_new, cross(), cross(),
                                dtype=engine.compute_dtype)
        common = dict(suppress=engine._suppress,
                      begin_suppress=engine._begin_suppress,
                      capture_alignment=timestamps,
                      no_speech_id=engine.special.no_speech)
        if beams > 1:
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
        beam (JAX's ``jnp.repeat`` on the batch axis)."""
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

    def capture(self, steps: int) -> None:
        """Capture ``steps`` step calls of the parked loop (every step a
        no-op until :meth:`decode` starts it), after one warm-up step."""
        loop = self.loop
        loop.park()
        t0 = time.perf_counter()
        self.graph = StepGraph(
            lambda: loop.steps(steps), lambda: loop.steps(1), self.device)
        self.seconds += time.perf_counter() - t0
        self.bytes += self.graph.bytes

    def decode(self, prompt: torch.Tensor, temperature: float = 0.0,
               generator: Optional[torch.Generator] = None):
        loop = self.loop
        if isinstance(loop, BeamLoop):
            loop.start(prompt)
            kw = {}
        else:
            loop.start(prompt, temperature, generator)
            kw = {"temperature": temperature, "generator": generator}
        replay = None if (self.graph is None or temperature) else self.graph.replay
        loop.run(STEPS_PER_CHECK, replay=replay, **kw)
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

    A greedy, sampled or beam call is padded up to the nearest of
    ``batch_buckets`` (:meth:`_speculative` says why a speculative one is
    not). On the card (``cuda_graphs``), greedy and beam calls replay a
    CUDA graph of ``STEPS_PER_CHECK`` decode steps for each static shape,
    captured at its first call or by :meth:`warmup`; ``cuda_graphs=False``
    runs the same steps eagerly. The host reads the loop's stop flag once
    every ``STEPS_PER_CHECK`` steps either way, and the outputs do not
    depend on it. The device buffers and graph of each static shape stay
    with the engine for its next call of that shape, for the
    ``MAX_PROGRAMS`` shapes used last; making one more frees the least
    recently used."""

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
        # and the lock that keeps one call at a time on their buffers.
        self._programs: "OrderedDict[Tuple, _Program]" = OrderedDict()
        self._lock = threading.Lock()

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

    def _features(self, mel) -> torch.Tensor:
        """(B, n_mels, T_mel) or (n_mels, T_mel) features, host or device,
        as a batched tensor on the engine's device."""
        if not isinstance(mel, torch.Tensor):
            mel = torch.from_numpy(np.array(mel, dtype=np.float32))
        if mel.ndim == 2:
            mel = mel[None]
        return mel.to(self.device)

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        bb = _bucket_batch(x.shape[0], self.batch_buckets)
        return x if bb == x.shape[0] else _pad_batch(x, bb)

    def _speculative(self, options: GenerationOptions, draft_tokens) -> bool:
        """Whether a call decodes speculatively: greedy, with a draft model,
        ngram drafting or proposal tokens. Such a call runs eagerly and is
        not padded to a bucket (no program is shared by a bucket's shapes,
        and a padded row's zero proposals would cost a verify round a
        token); JAX pads it for its compiled program. Its rows' tokens are
        greedy's either way; its verify-round count may differ from JAX's
        at a batch that is no bucket."""
        return (options.num_beams == 1 and not options.temperature and (
            self.draft_model is not None or self.spec_ngram
            or draft_tokens is not None))

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
        return torch.from_numpy(arr).to(self.device)

    def transcribe_features(
        self,
        mel,                                  # (B, n_mels, T_mel)
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
        draft_tokens=None,                    # (B, <= max_new) proposals
    ) -> EngineResult:
        t0 = time.perf_counter()
        mel = self._features(mel)
        b = mel.shape[0]
        if not self._speculative(options, draft_tokens):
            mel = self._padded(mel)
        return self._generate(mel, b, options, languages, t0, draft_tokens)

    def transcribe_audio(
        self,
        audio,                                # (B, n_samples) f32, padded
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
        draft_tokens=None,                    # (B, <= max_new) proposals
    ) -> EngineResult:
        """Raw audio (already padded to the chunk, ``n_samples % 160 == 0``)
        -> features through the K1 kernel -> :meth:`transcribe_features`."""
        t0 = time.perf_counter()
        x = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
        if x.ndim == 1:
            x = x[None]
        b = x.shape[0]
        if not self._speculative(options, draft_tokens):
            x = self._padded(x)       # before featurizing, as JAX pads
        with torch.inference_mode():
            mel = log_mel_spectrogram(x, self._mel_fb, self._window)
        return self._generate(mel, b, options, languages, t0, draft_tokens)

    def _generate(self, mel: torch.Tensor, b: int, options: GenerationOptions,
                  languages, t0: float, draft_tokens=None) -> EngineResult:
        """Decode ``mel`` (bb rows: the call's ``b`` rows, padded to their
        bucket unless speculative) and return the first ``b`` rows on the
        host."""
        bb = mel.shape[0]
        max_new = options.max_new_tokens
        beams = options.num_beams
        if beams < 1:
            raise ValueError(f"num_beams {beams} < 1")
        temperature = float(options.temperature) if beams == 1 else 0.0
        props = self._prep_proposals(draft_tokens, options, bb)
        spec = self._speculative(options, props)
        with torch.inference_mode():
            prompt = torch.from_numpy(
                self._prompt_rows(options, bb, languages)).long().to(self.device)
            p = prompt.shape[1]
            enc = encoder_forward(self.model, mel)
            if not spec:
                key = (bb, mel.shape[-1], p, max_new,
                       bool(options.return_timestamps), beams)
                with self._lock:
                    res = self._decode(key, enc, prompt, temperature,
                                       options.seed)
                    return self._unpack(res, b, p, options, t0)
            ck, cv = compute_cross_kv(self.model, enc)
            if self.cross_kv_int8:
                ck, cv = quantize_kv(ck), quantize_kv(cv)
            common = dict(suppress=self._suppress,
                          begin_suppress=self._begin_suppress,
                          capture_alignment=options.return_timestamps,
                          no_speech_id=self.special.no_speech)
            w = self.spec_window
            s_cap = p + max_new + w + 1
            cache = make_cache(self.arch, bb, s_cap, ck, cv,
                               dtype=self.compute_dtype)
            draft = d_cache = None
            if props is None and not self.spec_ngram:
                draft = self.draft_model
                dck, dcv = (kv.to(self.compute_dtype)
                            for kv in compute_cross_kv(draft, enc))
                d_cache = make_cache(draft.arch, bb, s_cap, dck, dcv)
            res = speculative_decode(
                self.model, draft, prompt, cache, d_cache, max_new,
                self.special.eot, spec_window=w,
                ngram_draft=self.spec_ngram and props is None,
                proposal_tokens=props, **common)
            return self._unpack(res, b, p, options, t0)

    def _decode(self, key: Tuple, enc: torch.Tensor, prompt: torch.Tensor,
                temperature: float, seed: int):
        """The loop of ``key``'s program on this call's encoder states and
        prompt: a graph replayed where the engine takes graphs (captured
        now if the key has none yet), else eager steps."""
        prog = self._programs.pop(key, None)
        if prog is None:
            while len(self._programs) >= MAX_PROGRAMS:
                self._programs.popitem(last=False)
            prog = _Program(self, key, enc.shape[1])
        self._programs[key] = prog
        prog.load(enc)
        if self.cuda_graphs and not temperature and prog.graph is None:
            prog.capture(STEPS_PER_CHECK)
        generator = None
        if temperature:
            generator = torch.Generator(self.device).manual_seed(seed)
        return prog.decode(prompt, temperature, generator)

    def _unpack(self, res, b: int, p: int, options: GenerationOptions,
                t0: float) -> EngineResult:
        """The first ``b`` rows of a decode result, copied to the host (on
        the CPU too: the rows may be a program's buffers, which its next
        call overwrites)."""
        def host(t):
            return t[:b].to("cpu", copy=True).numpy()

        align = None
        if options.return_timestamps:
            # Shipped at compute precision, as the JAX engine does.
            align = host(res.align.to(self.compute_dtype).float())
        out = [host(t) for t in (
            res.tokens, res.num_generated, res.sum_logprob,
            res.token_logprobs, res.no_speech_prob)]
        dt = time.perf_counter() - t0
        self.total_time_worked += dt
        return EngineResult(
            tokens=out[0], num_generated=out[1], prompt_len=p,
            sum_logprob=out[2], align=align, decode_time_s=dt,
            token_logprobs=out[3], no_speech_prob=out[4],
            spec_rounds=getattr(res, "rounds", None),
            decode_steps=res.steps)

    def warmup(self, t_mel: int, batches: Sequence[int] = (1,),
               max_new_tokens: int = 128, timestamps: bool = True,
               num_beams: int = 1) -> None:
        """Make the decode programs (on the card: capture their graphs) of
        the buckets of ``batches`` at ``t_mel`` mel frames, by one call of
        zeros each, so that a request of those shapes never pays a capture
        (JAX's ``warmup``, which compiles)."""
        for b in batches:
            opts = GenerationOptions(
                max_new_tokens=max_new_tokens, return_timestamps=timestamps,
                num_beams=num_beams)
            mel = np.zeros((b, self.arch.n_mels, t_mel), np.float32)
            self.transcribe_features(mel, opts)

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
        encoder); each also quantizes the cross K/V. ``"int4"`` ("S4") is
        not ported (ROADMAP Queue 1 item 9).

        ``draft`` makes greedy calls speculative: ``"ngram"`` (prompt
        lookup), ``"layer-skip:N"`` (the target's first N decoder layers,
        taken after quantization), a ``.npz`` written by either package's
        ``save_draft``, or another checkpoint directory (same width and
        vocab; its encoder is dropped). In the "S" modes the draft's
        decoder is weight-only int8 too (``draft_int8``)."""
        from thewhisper_tpu_torch.models.load import load_checkpoint

        if quantize == "int4":
            raise NotImplementedError(
                "quantize='int4' (\"S4\") is not ported yet "
                "(ROADMAP Queue 1 item 9)")
        if quantize not in (None, "int8", "int8-weights", "int8-all"):
            raise ValueError(f"unknown quantize mode: {quantize}")
        model, _ = load_checkpoint(
            path, dtype=compute_dtype, device=device,
            chunk_length_s=chunk_length_s, position_mode=position_mode)
        if quantize is not None:
            quantize_params(model, components=("decoder",),
                            quantize_embedding_table=quantize != "int8-weights")
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
