"""WhisperEngine: features or audio in, decoded tokens out (port of
thewhisper_tpu's ``engine/engine.py``).

PyTorch runs eagerly, so there are no compiled programs to bucket: a call
featurizes (the K1 kernel on the card), encodes (K2 in every encoder
layer), computes the cross K/V, prefills the prompt and runs the greedy
loop, then copies the result to the host as an :class:`EngineResult` with
the JAX engine's fields. The "S" modes quantize the model
(``models.quant``) and the cross K/V, and a batch-1 bf16 "S" engine on a
deep decoder decodes through the K3 kernel (``ops.mega_step``). With a
draft model, ngram drafting or proposal tokens a greedy call decodes
speculatively (``engine.speculative``; its batch-1 "S" verify rounds run
K4). Beam search, int4, the async handles and the window-scan programs are
not ported yet.
"""

from __future__ import annotations

import copy
import json
import os
import time
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
from thewhisper_tpu_torch.engine.decode import greedy_decode, suppress_mask
from thewhisper_tpu_torch.engine.speculative import (
    load_draft,
    make_layer_skip_draft,
    speculative_decode,
)
from thewhisper_tpu_torch.models.quant import quantize_kv, quantize_params
from thewhisper_tpu_torch.models.whisper import (
    Whisper,
    compute_cross_kv,
    decoder_prefill,
    encoder_forward,
    fuse_self_qkv,
    make_cache,
)
from thewhisper_tpu_torch.ops.mega_step import mega_pays, pack_mega_params


class EngineResult(NamedTuple):
    """Host-side result of a transcription call."""

    tokens: np.ndarray         # (B, P+max_new) int32
    num_generated: np.ndarray  # (B,)
    prompt_len: int
    sum_logprob: np.ndarray    # (B,)
    align: Optional[np.ndarray]  # (B, A, P+max_new, T_enc) or None
    decode_time_s: float
    token_logprobs: Optional[np.ndarray] = None  # (B, max_new)
    no_speech_prob: Optional[np.ndarray] = None  # (B,)
    spec_rounds: Optional[int] = None  # verify rounds run (speculative)


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
    int8, in place; layers it shares with the target are copied first)."""

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
        return self._generate(self._features(mel), options, languages, t0,
                              draft_tokens)

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
        with torch.inference_mode():
            mel = log_mel_spectrogram(x, self._mel_fb, self._window)
        return self._generate(mel, options, languages, t0, draft_tokens)

    def _generate(self, mel: torch.Tensor, options: GenerationOptions,
                  languages, t0: float, draft_tokens=None) -> EngineResult:
        if options.num_beams != 1:
            raise NotImplementedError("beam search is not ported yet")
        b = mel.shape[0]
        max_new = options.max_new_tokens
        props = self._prep_proposals(draft_tokens, options, b)
        spec = not options.temperature and (
            self.draft_model is not None or self.spec_ngram
            or props is not None)
        with torch.inference_mode():
            prompt = torch.from_numpy(
                self._prompt_rows(options, b, languages)).long().to(self.device)
            p = prompt.shape[1]
            enc = encoder_forward(self.model, mel)
            ck, cv = compute_cross_kv(self.model, enc)
            if self.cross_kv_int8:
                ck, cv = quantize_kv(ck), quantize_kv(cv)
            common = dict(suppress=self._suppress,
                          begin_suppress=self._begin_suppress,
                          capture_alignment=options.return_timestamps,
                          no_speech_id=self.special.no_speech)
            if spec:
                w = self.spec_window
                s_cap = p + max_new + w + 1
                cache = make_cache(self.arch, b, s_cap, ck, cv,
                                   dtype=self.compute_dtype)
                draft = d_cache = None
                if props is None and not self.spec_ngram:
                    draft = self.draft_model
                    dck, dcv = (kv.to(self.compute_dtype)
                                for kv in compute_cross_kv(draft, enc))
                    d_cache = make_cache(draft.arch, b, s_cap, dck, dcv)
                res = speculative_decode(
                    self.model, draft, prompt, cache, d_cache, max_new,
                    self.special.eot, spec_window=w,
                    ngram_draft=self.spec_ngram and props is None,
                    proposal_tokens=props, **common)
            else:
                cache = make_cache(self.arch, b, p + max_new, ck, cv,
                                   dtype=self.compute_dtype)
                generator = None
                if options.temperature:
                    generator = torch.Generator(self.device).manual_seed(
                        options.seed)
                res = greedy_decode(
                    self.model, prompt, cache, max_new, self.special.eot,
                    temperature=float(options.temperature),
                    generator=generator, **common)
            align = None
            if options.return_timestamps:
                # Shipped at compute precision, as the JAX engine does.
                align = res.align.to(self.compute_dtype).float().cpu().numpy()
            host = [t.cpu().numpy() for t in (
                res.tokens, res.num_generated, res.sum_logprob,
                res.token_logprobs, res.no_speech_prob)]
        dt = time.perf_counter() - t0
        self.total_time_worked += dt
        return EngineResult(
            tokens=host[0], num_generated=host[1], prompt_len=p,
            sum_logprob=host[2], align=align, decode_time_s=dt,
            token_logprobs=host[3], no_speech_prob=host[4],
            spec_rounds=res.rounds)

    def detect_language(self, mel) -> Tuple[np.ndarray, np.ndarray]:
        """Spoken language from features: one forced decoder pass from
        ``<|startoftranscript|>``, softmax over the language-token block.
        Returns (language codes (B,), probabilities (B,))."""
        mel = self._features(mel)
        b = mel.shape[0]
        sp = self.special
        with torch.inference_mode():
            enc = encoder_forward(self.model, mel)
            ck, cv = compute_cross_kv(self.model, enc)
            cache = make_cache(self.arch, b, 4, ck, cv)
            sot = torch.full((b, 1), sp.sot, dtype=torch.long, device=self.device)
            logits, _, _ = decoder_prefill(self.model, sot, cache)
            lang_logits = logits[:, -1, sp.first_language:
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
