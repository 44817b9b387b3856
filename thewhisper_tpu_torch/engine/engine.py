"""WhisperEngine: features or audio in, decoded tokens out (port of
thewhisper_tpu's ``engine/engine.py``).

PyTorch runs eagerly, so there are no compiled programs to bucket: a call
featurizes (the K1 kernel on the card), encodes (K2 in every encoder
layer), computes the cross K/V, prefills the prompt and runs the greedy
loop, then copies the result to the host as an :class:`EngineResult` with
the JAX engine's fields. The "S" modes quantize the model
(``models.quant``) and the cross K/V, and a batch-1 bf16 "S" engine on a
deep decoder decodes through the K3 kernel (``ops.mega_step``). Beam
search, speculative drafts, int4, the async handles and the window-scan
programs are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from thewhisper_tpu.config import (
    GenerationOptions,
    LANGUAGES,
    SpecialTokens,
    WhisperArch,
)
from thewhisper_tpu_torch.audio.features import (
    hann_window,
    log_mel_spectrogram,
    mel_filter_bank,
)
from thewhisper_tpu_torch.engine.decode import greedy_decode, suppress_mask
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


class WhisperEngine:
    """Whisper inference on one device (the model's).

    ``cross_kv_int8`` quantizes the cross K/V of every call
    (``models.quant.quantize_kv``). With it and ``megakernel``, a decoder
    where ``ops.mega_step.mega_pays`` gets its self q/k/v fused and K3's
    operands packed, in place (a no-op unless the decoder is weight-only
    int8), so batch-1 bf16 greedy steps run as one launch."""

    def __init__(
        self,
        model: Whisper,
        special: Optional[SpecialTokens] = None,
        suppress_tokens: Sequence[int] = (),
        begin_suppress_tokens: Sequence[int] = (),
        cross_kv_int8: bool = False,
        megakernel: bool = True,
    ):
        self.cross_kv_int8 = cross_kv_int8
        if (cross_kv_int8 and megakernel and model.mega is None
                and mega_pays(model.arch)):
            pack_mega_params(fuse_self_qkv(model))
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

    def transcribe_features(
        self,
        mel,                                  # (B, n_mels, T_mel)
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
    ) -> EngineResult:
        t0 = time.perf_counter()
        return self._generate(self._features(mel), options, languages, t0)

    def transcribe_audio(
        self,
        audio,                                # (B, n_samples) f32, padded
        options: GenerationOptions,
        languages: Optional[Sequence[str]] = None,
    ) -> EngineResult:
        """Raw audio (already padded to the chunk, ``n_samples % 160 == 0``)
        -> features through the K1 kernel -> :meth:`transcribe_features`."""
        t0 = time.perf_counter()
        x = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
        if x.ndim == 1:
            x = x[None]
        with torch.inference_mode():
            mel = log_mel_spectrogram(x, self._mel_fb, self._window)
        return self._generate(mel, options, languages, t0)

    def _generate(self, mel: torch.Tensor, options: GenerationOptions,
                  languages, t0: float) -> EngineResult:
        if options.num_beams != 1:
            raise NotImplementedError("beam search is not ported yet")
        b = mel.shape[0]
        with torch.inference_mode():
            prompt = torch.from_numpy(
                self._prompt_rows(options, b, languages)).long().to(self.device)
            p = prompt.shape[1]
            enc = encoder_forward(self.model, mel)
            ck, cv = compute_cross_kv(self.model, enc)
            if self.cross_kv_int8:
                ck, cv = quantize_kv(ck), quantize_kv(cv)
            cache = make_cache(self.arch, b, p + options.max_new_tokens, ck, cv,
                               dtype=self.compute_dtype)
            generator = None
            if options.temperature:
                generator = torch.Generator(self.device).manual_seed(options.seed)
            res = greedy_decode(
                self.model, prompt, cache, options.max_new_tokens,
                self.special.eot, suppress=self._suppress,
                begin_suppress=self._begin_suppress,
                capture_alignment=options.return_timestamps,
                no_speech_id=self.special.no_speech,
                temperature=float(options.temperature), generator=generator)
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
            token_logprobs=host[3], no_speech_prob=host[4])

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
    ) -> "WhisperEngine":
        """Build an engine from an HF checkpoint directory, with the
        suppress-token lists of its generation config.

        ``quantize`` selects an "S" mode, as in the JAX engine: ``"int8"``
        (weight-only int8 decoder and tied table), ``"int8-weights"`` (the
        table stays float), ``"int8-all"`` (``"int8"`` plus a W8A8
        encoder); each also quantizes the cross K/V. ``"int4"`` ("S4") is
        not ported (ROADMAP Queue 1 item 9)."""
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
                             cross_kv_int8=quantize is not None)
