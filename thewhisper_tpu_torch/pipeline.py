"""Offline ASR pipeline: long-form windowing, batched decode, word merge
(port of thewhisper_tpu's ``pipeline.py``).

Same surface and output as the JAX ``ASRPipeline``:
``pipeline(audio, return_timestamps="word", generate_kwargs=..., chunk_length_s=...)``
returns ``{"text": str, "chunks": [{"text", "timestamp": (start, end)}]}``.
Windows of the call's ``chunk_length_s`` overlap by a sixth on each side,
are padded to the smallest latency bucket that holds them (the model chunk
unless ``latency_buckets`` says otherwise), decoded ``batch_size`` at a
time, and merged by the timestamp-aware LCS of ``text.py``; word
timestamps come from the DTW of ``align.py``.

A long file with a forced language, greedy and without the fallback
ladder takes the offset path, as in JAX: the file goes to the device once,
padded by one model window, and each group of windows is one engine call
that slices its windows there (``engine.transcribe_windows_async``). Up to
``pipeline_depth`` calls are dispatched ahead of the fetch, so the card
encodes the next windows while the host unpacks, aligns and merges
(``engine.PendingResult``); ``windows_per_program`` groups W windows at
batch 1, or G full batches, under one handle; ``first_window_fast`` decodes
window 0 alone ahead of the batches. None of this changes an output: each
path gives the tokens and times of the plain batched one.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from thewhisper_tpu_torch.align import token_timestamps_from_alignment
from thewhisper_tpu_torch.audio.features import LogMelFeaturizer
from thewhisper_tpu_torch.audio.io import load_audio
from thewhisper_tpu_torch.config import GenerationOptions, SAMPLE_RATE
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.engine.engine import to_device
from thewhisper_tpu_torch.text import combine_tokens_into_words, find_longest_common_sequence

# Engine calls dispatched ahead of the fetch on the pipelined paths (see
# _decode_windows): 2 keeps the card busy, one call decoding and one
# encoded, while bounding how long a result waits.
PIPELINE_DEPTH = 2


class ASRPipeline:
    """Offline transcription on the torch engine.

    ``model`` is an HF checkpoint directory path or a ready
    :class:`WhisperEngine`. ``tokenizer`` is anything with
    ``decode(ids, skip_special_tokens=True) -> str``.

    ``latency_buckets``: seconds below the model chunk at which a short
    buffer or call window is featurized and encoded (fewer encoder
    positions) instead of padding to the chunk. ``pipeline_depth``: calls
    in flight ahead of the fetch (None: ``PIPELINE_DEPTH``; 0: one at a
    time). ``windows_per_program``: on the offset path, W windows at batch
    1, or G full batches, under one handle. ``first_window_fast``: on the
    batched offset path, window 0 decodes alone ahead of the batches;
    ``last_first_result_s`` is then the seconds from the call's start to
    its tokens on the host, and ``on_first_result`` (a callable) receives
    its text.
    """

    def __init__(
        self,
        model: Union[str, WhisperEngine],
        tokenizer: Any = None,
        model_size: Optional[str] = None,   # None/"XL" bf16, "XL32" f32, "S"
        chunk_length_s: int = 30,
        language: str = "en",
        compute_dtype: Optional[torch.dtype] = None,
        position_mode: Optional[str] = None,
        batch_size: int = 8,
        latency_buckets: Optional[Sequence[float]] = None,
        device="cuda",
        draft: Optional[str] = None,        # speculative decoding (engine doc)
        reuse_previous_tokens: bool = False,
        pipeline_depth: Optional[int] = None,
        windows_per_program: int = 1,
        first_window_fast: bool = False,
    ):
        if isinstance(model, WhisperEngine):
            self.engine = model
        else:
            if model_size not in (None, "XL", "XL32", "S", "S-legacy"):
                raise NotImplementedError(
                    f"model_size={model_size!r} is not ported yet")
            dtype = compute_dtype or (torch.float32 if model_size == "XL32"
                                      else torch.bfloat16)
            # "S": int8 end to end (weight-only int8 decoder and table,
            # W8A8 encoder, int8 cross K/V); "S-legacy" keeps the encoder
            # float. The JAX pipeline's mapping.
            quant = {"S": "int8-all", "S-legacy": "int8"}.get(model_size)
            self.engine = WhisperEngine.from_checkpoint(
                model, chunk_length_s=chunk_length_s, compute_dtype=dtype,
                position_mode=position_mode, device=device, quantize=quant,
                draft=draft)
            if tokenizer is None:
                tokenizer = _try_load_hf_tokenizer(model)
        self.tokenizer = tokenizer
        self.model_chunk_length_s = float(chunk_length_s)
        self.language = language
        self.batch_size = batch_size
        buckets = sorted(set(
            float(b) for b in (latency_buckets or [])
            if 0 < float(b) <= self.model_chunk_length_s))
        if self.model_chunk_length_s not in buckets:
            buckets.append(self.model_chunk_length_s)
        self.latency_buckets = buckets
        self._featurizers: Dict[float, LogMelFeaturizer] = {}
        self.featurizer = self._featurizer_for(self.model_chunk_length_s)
        # Cross-call speculative reuse (see _transcribe_with_fallback).
        self._reuse_previous = bool(reuse_previous_tokens)
        self._prev_gen_tokens: Optional[np.ndarray] = None
        self.pipeline_depth = pipeline_depth
        self.windows_per_program = max(1, int(windows_per_program))
        self.first_window_fast = bool(first_window_fast)
        self.last_first_result_s: Optional[float] = None
        self.on_first_result: Optional[Any] = None

    def _featurizer_for(self, bucket_s: float) -> LogMelFeaturizer:
        feat = self._featurizers.get(bucket_s)
        if feat is None:
            feat = self._featurizers[bucket_s] = LogMelFeaturizer(
                n_mels=self.engine.arch.n_mels, chunk_length_s=bucket_s,
                device=self.engine.device)
        return feat

    def _pick_bucket(self, longest_s: float) -> float:
        for b in self.latency_buckets:
            if longest_s <= b:
                return b
        return self.model_chunk_length_s

    # -- token decode helper -------------------------------------------------

    def _decode(self, ids: Sequence[int]) -> str:
        if self.tokenizer is None:
            # Debug fallback: space-joined ids.
            return "".join(f" <{i}>" for i in ids)
        return self.tokenizer.decode(list(ids), skip_special_tokens=True)

    # -- windowing -----------------------------------------------------------

    @staticmethod
    def _window_offsets(n_samples: int, win: int, step: int) -> List[int]:
        if n_samples <= win:
            return [0]
        offsets = list(range(0, n_samples - win + step, step))
        # Drop a trailing window that would contain no new audio.
        return [o for o in offsets if o < n_samples]

    # -- main entry ----------------------------------------------------------

    def __call__(
        self,
        audio: Union[str, np.ndarray],
        return_timestamps: Union[bool, str] = False,
        generate_kwargs: Optional[Dict[str, Any]] = None,
        chunk_length_s: Optional[float] = None,
        batch_size: Optional[int] = None,
    ) -> Dict[str, Any]:
        self._call_t0 = time.perf_counter()
        self.last_first_result_s = None
        if isinstance(audio, str):
            audio = load_audio(audio, sr=SAMPLE_RATE)
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)

        gk = dict(generate_kwargs or {})
        _MISSING = object()
        lang_kw = gk.pop("language", _MISSING)
        # {"language": None} requests auto-detection (HF convention).
        language = self.language if lang_kw is _MISSING else lang_kw
        max_new_tokens = int(gk.pop("max_new_tokens", 224))
        task = gk.pop("task", "transcribe")
        num_beams = int(gk.pop("num_beams", 1))
        fallback = _fallback_ladder(gk.pop("fallback_temperatures", None))
        ts_mode = _timestamp_mode(return_timestamps)
        want_words = ts_mode is not None

        win_s = min(float(chunk_length_s or self.model_chunk_length_s),
                    self.model_chunk_length_s)
        win = int(win_s * SAMPLE_RATE)
        stride = int(win_s / 6 * SAMPLE_RATE)
        step = max(1, win - 2 * stride)
        offsets = self._window_offsets(len(audio), win, step)
        bsz = batch_size or self.batch_size
        depth = (PIPELINE_DEPTH if self.pipeline_depth is None
                 else self.pipeline_depth)
        opts = GenerationOptions(
            max_new_tokens=max_new_tokens, language=language, task=task,
            return_timestamps=want_words, num_beams=num_beams,
        )
        # Call windows ride a latency bucket too: a 9 s window on a 9 s
        # bucket encodes 450 positions, not the 10 s chunk's 500.
        bucket_s = self._pick_bucket(win_s)

        # The offset path (long-form): greedy, a forced language, no
        # fallback ladder, no cross-call reuse; output identical to the
        # batched path. The file is padded by the MODEL window, so that no
        # call window's slice reads past it.
        offset_mode = (
            len(offsets) >= 3 and depth > 0
            and fallback is None and language is not None
            and num_beams == 1 and not self._reuse_previous
            and hasattr(self.engine, "transcribe_windows_async"))
        if offset_mode:
            win_model = int(self.model_chunk_length_s * SAMPLE_RATE)
            dev = to_device(audio, self.engine.device,
                            length=len(audio) + win_model)
            lens = [min(win, len(audio) - o) for o in offsets]
            bucket_samples = self._featurizer_for(bucket_s).n_samples
            seqs, ts_seqs, _, langs = self._decode_windows_offset(
                dev, offsets, lens, win, bucket_samples, opts, want_words,
                depth, bsz)
        else:
            if len(offsets) >= 3:
                # Long-form: the file goes to the device once and its
                # windows are sliced there.
                dev = to_device(audio, self.engine.device)
                windows = [dev[o: o + win] for o in offsets]
            else:
                windows = [audio[o: o + win] for o in offsets]
            # Cross-call reuse only when the audio is one window (a rolling
            # buffer); a multi-window file would feed one window's tokens as
            # the guess for another.
            seqs, ts_seqs, _, langs = self._decode_windows(
                windows, offsets, opts, bsz, want_words, fallback=fallback,
                allow_reuse=(len(windows) == 1), bucket_s=bucket_s)

        if len(seqs) == 1:
            tokens, token_ts_list = seqs[0], (ts_seqs[0] if want_words else None)
        elif want_words:
            tokens, token_ts_list = find_longest_common_sequence(seqs, ts_seqs)
        else:
            tokens = find_longest_common_sequence(seqs)
            token_ts_list = None

        # Word segmentation follows the (possibly detected) language: one
        # file takes the majority vote over its windows.
        out_language = language
        if out_language is None and langs:
            out_language = max(set(langs), key=langs.count)
        return self._format_output(tokens, token_ts_list, out_language,
                                   ts_mode)

    def transcribe_batch(
        self,
        audios: Sequence[np.ndarray],
        return_timestamps: Union[bool, str] = "word",
        generate_kwargs: Optional[Dict[str, Any]] = None,
        languages: Optional[Sequence[Optional[str]]] = None,
    ) -> List[Dict[str, Any]]:
        """Transcribe N independent short buffers in ONE engine call (each
        truncated to the model chunk, featurized at the smallest latency
        bucket that holds the longest). ``languages``: optional per-row
        forced language codes; ``None`` entries take the call's language,
        or are detected when that is None too."""
        gk = dict(generate_kwargs or {})
        _MISSING = object()
        lang_kw = gk.pop("language", _MISSING)
        language = self.language if lang_kw is _MISSING else lang_kw
        max_new_tokens = int(gk.pop("max_new_tokens", 128))
        task = gk.pop("task", "transcribe")
        num_beams = int(gk.pop("num_beams", 1))
        fallback = _fallback_ladder(gk.pop("fallback_temperatures", None))
        ts_mode = _timestamp_mode(return_timestamps)
        want_words = ts_mode is not None
        win = int(self.model_chunk_length_s * SAMPLE_RATE)
        windows = [np.asarray(a, np.float32).reshape(-1)[:win] for a in audios]
        bucket_s = self._pick_bucket(
            max((len(w) for w in windows), default=0) / SAMPLE_RATE)
        row_languages = None
        if languages is not None and any(l for l in languages):
            fill: List[Optional[str]] = [language] * len(windows)
            need = [i for i in range(len(windows))
                    if language is None
                    and not (i < len(languages) and languages[i])]
            if need:
                feat = self._featurizer_for(bucket_s)
                mel = feat(_pad_stack(windows, feat.n_samples))
                codes, _ = self.engine.detect_language(mel)
                for i in need:
                    fill[i] = str(codes[i])
            row_languages = [
                languages[i] if i < len(languages) and languages[i]
                else (fill[i] or "en")
                for i in range(len(windows))]
        opts = GenerationOptions(
            max_new_tokens=max_new_tokens, language=language, task=task,
            return_timestamps=want_words, num_beams=num_beams,
        )
        seqs, ts_seqs, lp_seqs, langs = self._decode_windows(
            windows, [0] * len(windows), opts, len(windows), want_words,
            bucket_s=bucket_s, with_logprobs=True, fallback=fallback,
            allow_reuse=True, row_languages=row_languages)
        return [
            self._format_output(
                seqs[i], ts_seqs[i] if want_words else None,
                (row_languages[i] if row_languages
                 else language if language is not None else langs[i]),
                ts_mode, token_logprobs=lp_seqs[i])
            for i in range(len(windows))
        ]

    # -- shared internals ----------------------------------------------------

    def _decode_windows(self, windows, offsets, opts, bsz, want_words,
                        bucket_s: Optional[float] = None,
                        with_logprobs: bool = False,
                        fallback: Optional[Sequence[float]] = None,
                        allow_reuse: bool = False,
                        row_languages: Optional[Sequence[str]] = None):
        """Run windows through the engine ``bsz`` at a time.

        Returns (seqs, ts_seqs, lp_seqs, langs): per-window token ids,
        (start, end) times, logprobs, and the language code (detected when
        ``opts.language is None``).

        With a forced language, no fallback ladder and no cross-call reuse,
        batch k's results are not needed to build batch k+1's inputs, so up
        to ``pipeline_depth`` calls are dispatched ahead of the fetch; the
        output is unchanged (only host work is reordered)."""
        featurizer = (self.featurizer if bucket_s is None
                      else self._featurizer_for(bucket_s))
        seqs: List[List[int]] = []
        ts_seqs: List[List[Tuple[Optional[float], Optional[float]]]] = []
        lp_seqs: List[List[float]] = []
        langs: List[Optional[str]] = []

        def consume(res, batch, start, languages):
            self._consume_result(
                res, [len(w) for w in batch], start, offsets, opts,
                want_words, with_logprobs, languages,
                seqs, ts_seqs, lp_seqs, langs)

        depth = (PIPELINE_DEPTH if self.pipeline_depth is None
                 else self.pipeline_depth)
        pipelined = (fallback is None and row_languages is None
                     and opts.language is not None
                     and not (self._reuse_previous and allow_reuse)
                     and hasattr(self.engine, "transcribe_audio_async"))
        pending: List[Tuple[Any, list, int]] = []
        try:
            for start in range(0, len(windows), bsz):
                batch = windows[start: start + bsz]
                audio = _pad_stack(batch, featurizer.n_samples)
                languages = None
                if row_languages is not None:
                    # Per-row forced languages: per-row prompts, no detection.
                    languages = list(row_languages[start: start + len(batch)])
                    res = self._transcribe_with_fallback(
                        audio, opts, fallback, languages=languages,
                        allow_reuse=allow_reuse)
                elif opts.language is None:
                    # Detect per sample; the features are reused for decoding.
                    mel = featurizer(audio)
                    codes, _ = self.engine.detect_language(mel)
                    languages = [str(c) for c in codes]
                    res = self._transcribe_with_fallback(
                        audio, opts, fallback, languages=languages, mel=mel,
                        allow_reuse=allow_reuse)
                elif pipelined:
                    pending.append((self.engine.transcribe_audio_async(
                        audio, opts), batch, start))
                    if len(pending) > depth:
                        h, b_, s_ = pending[0]
                        consume(h.result(), b_, s_, None)
                        pending.pop(0)
                    continue
                else:
                    res = self._transcribe_with_fallback(
                        audio, opts, fallback, allow_reuse=allow_reuse)
                consume(res, batch, start, languages)
            while pending:
                h, b_, s_ = pending[0]
                consume(h.result(), b_, s_, None)
                pending.pop(0)
        finally:
            for h, _, _ in pending:
                h.release()
        return seqs, ts_seqs, lp_seqs, langs

    def _consume_result(self, res, lens, start, offsets, opts, want_words,
                        with_logprobs, languages,
                        seqs, ts_seqs, lp_seqs, langs):
        """Unpack one EngineResult batch into the per-window accumulators
        (shared by the batched and offset-window paths). ``lens``: true
        (unpadded) sample counts per row."""
        nb = len(lens)
        langs.extend((languages or [opts.language] * nb)[:nb])
        p = res.prompt_len
        if want_words:
            # Alignment rows populated per sample: prompt + generated - 1.
            num_rows = p + np.maximum(res.num_generated, 1) - 1
            token_ts = token_timestamps_from_alignment(
                res.align, num_rows,
                num_frames=np.asarray([ln // 160 for ln in lens]),
                median_filter_width=self.engine.arch.median_filter_width,
            )
        for bi in range(nb):
            n = int(res.num_generated[bi])
            raw = res.tokens[bi, p: p + n].tolist()
            keep = [j for j, t in enumerate(raw)
                    if t < self.engine.special.eot]
            seqs.append([raw[j] for j in keep])
            if with_logprobs:
                lp_seqs.append(
                    [float(res.token_logprobs[bi, j]) for j in keep])
            if want_words:
                # Alignment rows are indexed by RAW generated position j: a
                # special token dropped mid-sequence must not shift them.
                offset_s = offsets[start + bi] / SAMPLE_RATE
                ts: List[Tuple[Optional[float], Optional[float]]] = []
                for j in keep:
                    t0 = float(token_ts[bi, p + j]) + offset_s
                    t1 = (float(token_ts[bi, p + j + 1]) + offset_s
                          if j + 1 < n else None)
                    ts.append((t0, t1))
                ts_seqs.append(ts)

    def _decode_windows_offset(self, dev_audio, offsets, lens, win,
                               bucket_samples, opts, want_words, depth,
                               bsz: int = 1):
        """The offset path: the file on the device once, each group of
        windows one engine call that slices them there, up to ``depth``
        calls ahead of the fetch; greedy only.

        With ``first_window_fast`` (batched), window 0 is dispatched alone
        first and consumed as soon as the first group is dispatched (the
        card is then never idle), before any group, so the windows stay in
        order. Whatever raises, the user's callback included, every handle
        not consumed is released and the exception reaches the caller."""
        seqs: List[List[int]] = []
        ts_seqs: List[List[Tuple[Optional[float], Optional[float]]]] = []
        lp_seqs: List[List[float]] = []
        langs: List[Optional[str]] = []
        pending: List[Tuple[Any, int, int]] = []
        first_h = None
        engine = self.engine

        def consume_first():
            nonlocal first_h
            if first_h is None:
                return
            # Wanted at once: the first group's encoder waits (its launches
            # would hold the host until most of it had run on the card).
            res = first_h.result(queue_next=False)
            first_h = None
            self._consume_result(res, [first_len], 0, [first_off],
                                 opts, want_words, False, None,
                                 seqs, ts_seqs, lp_seqs, langs)
            self.last_first_result_s = time.perf_counter() - self._call_t0
            if self.on_first_result is not None:
                self.on_first_result(self._decode(seqs[0]))

        def drain_one():
            consume_first()
            h, s_, n_ = pending[0]
            res = h.result()
            pending.pop(0)
            self._consume_result(res, lens[s_: s_ + n_], s_, offsets,
                                 opts, want_words, False, None,
                                 seqs, ts_seqs, lp_seqs, langs)

        def dispatch(handle, start, n):
            pending.append((handle, start, n))
            consume_first()   # group 1 is queued; block on window 0
            if len(pending) > depth:
                drain_one()

        try:
            if (bsz > 1 and self.first_window_fast and len(offsets) > 1
                    and hasattr(engine, "transcribe_window_async")):
                first_h = engine.transcribe_window_async(
                    dev_audio, int(offsets[0]), win, bucket_samples, opts)
                first_off, first_len = offsets[0], lens[0]
                offsets, lens = offsets[1:], lens[1:]

            wpp = self.windows_per_program
            spec_engine = (getattr(engine, "spec_ngram", False)
                           or getattr(engine, "draft_model", None) is not None)
            scan_ok = (bsz == 1 and wpp > 1 and not spec_engine
                       and hasattr(engine, "transcribe_window_scan_async"))
            batch_scan_ok = (bsz > 1 and wpp > 1 and not spec_engine
                             and hasattr(engine, "transcribe_batch_scan_async"))
            buckets = getattr(engine, "batch_buckets", (bsz,))
            start = 0
            if batch_scan_ok:
                # G full bsz-sized groups under one handle; a single or
                # remainder (possibly short) group is one plain batched
                # call, a short tail split to the largest bucket that fits.
                n_full = (len(offsets) // bsz) * bsz
                while start < len(offsets):
                    g = (n_full - start) // bsz if start < n_full else 0
                    g = min(wpp, g)
                    if g >= 2:
                        group = [int(o) for o in offsets[start: start + g * bsz]]
                        handle = engine.transcribe_batch_scan_async(
                            dev_audio, group, g, bsz, win, bucket_samples, opts)
                    else:
                        n = _tail_fit(len(offsets) - start, bsz, buckets)
                        group = [int(o) for o in offsets[start: start + n]]
                        handle = engine.transcribe_windows_async(
                            dev_audio, group, win, bucket_samples, opts)
                    dispatch(handle, start, len(group))
                    start += len(group)
            else:
                group_n = wpp if scan_ok else bsz
                while start < len(offsets):
                    n = (group_n if scan_ok
                         else _tail_fit(len(offsets) - start, group_n, buckets))
                    group = [int(o) for o in offsets[start: start + n]]
                    if scan_ok:
                        # W windows at batch 1 under one handle.
                        handle = engine.transcribe_window_scan_async(
                            dev_audio, group, wpp, win, bucket_samples, opts)
                    elif len(group) == 1:
                        # The single-window call (the bs=1 protocol's shape).
                        handle = engine.transcribe_window_async(
                            dev_audio, group[0], win, bucket_samples, opts)
                    else:
                        handle = engine.transcribe_windows_async(
                            dev_audio, group, win, bucket_samples, opts)
                    dispatch(handle, start, len(group))
                    start += len(group)
            while pending:
                drain_one()
        finally:
            for h in [first_h] + [p[0] for p in pending]:
                if h is not None:
                    h.release()
        return seqs, ts_seqs, lp_seqs, langs

    # -- temperature fallback ladder (opt-in) --------------------------------

    def _transcribe_with_fallback(self, audio, opts, temperatures,
                                  languages=None, mel=None,
                                  allow_reuse: bool = False):
        """openai-whisper style quality gating: windows whose output is
        repetitive (zlib compression ratio > 2.4) or low-confidence (mean
        token logprob < -1.0) are re-decoded by sampling at the next
        temperature in the ladder. Off unless ``fallback_temperatures`` is
        passed in generate_kwargs. ``mel``: features already computed for
        this audio (the language-detection path).

        With ``reuse_previous_tokens`` and ``allow_reuse``, the previous
        call's generated tokens ride as speculative proposals when the batch
        has as many rows: a rolling buffer re-transcribed a tick later
        repeats most of them, so most rounds accept the whole window. The
        greedy output is unchanged."""
        reuse = self._reuse_previous and allow_reuse
        draft = None
        if (reuse and opts.num_beams == 1 and not opts.temperature
                and self._prev_gen_tokens is not None
                and self._prev_gen_tokens.shape[0] == audio.shape[0]):
            draft = self._prev_gen_tokens
        if mel is not None:
            res = self.engine.transcribe_features(
                mel, opts, languages=languages, draft_tokens=draft)
        else:
            res = self.engine.transcribe_audio(
                audio, opts, languages=languages, draft_tokens=draft)
        if reuse:
            self._prev_gen_tokens = np.asarray(
                res.tokens[:, res.prompt_len:], np.int32)
        if not temperatures or opts.num_beams != 1:
            return res
        for step, t in enumerate(t for t in temperatures if t > 0.0):
            failed = [i for i in range(audio.shape[0])
                      if self._window_fails(res, i)]
            if not failed:
                break
            retry_opts = dataclasses.replace(
                opts, temperature=float(t), seed=opts.seed + step + 1)
            sub = self.engine.transcribe_audio(
                audio[failed], retry_opts,
                languages=([languages[i] for i in failed]
                           if languages else None))
            res = _merge_result_rows(res, sub, failed)
        return res

    def _window_fails(self, res, i: int) -> bool:
        n = int(res.num_generated[i])
        if n <= 0:
            return False
        if float(res.sum_logprob[i]) / n < -1.0:
            return True
        ids = [int(t) for t in res.tokens[i, res.prompt_len: res.prompt_len + n]
               if int(t) < self.engine.special.eot]
        text = self._decode(ids).encode("utf-8")
        if len(text) < 16:
            return False
        return len(text) / len(zlib.compress(text)) > 2.4

    def _format_output(self, tokens, token_ts_list, language, ts_mode,
                       token_logprobs: Optional[List[float]] = None):
        out: Dict[str, Any] = {"text": self._decode(tokens)}
        if ts_mode is not None:
            words, _, indices = combine_tokens_into_words(
                self._decode, tokens, language=language,
                special_id=self.engine.special.eot,
            )
            chunks = []
            for w, idx in zip(words, indices):
                chunk: Dict[str, Any] = {
                    "text": w,
                    "timestamp": (token_ts_list[idx[0]][0],
                                  token_ts_list[idx[-1]][1])}
                if token_logprobs is not None:
                    lps = [token_logprobs[j] for j in idx
                           if j < len(token_logprobs)]
                    if lps:
                        chunk["confidence"] = float(np.exp(np.mean(lps)))
                chunks.append(chunk)
            if ts_mode == "segment":
                chunks = _group_words_into_segments(chunks)
            out["chunks"] = chunks
        return out


def _tail_fit(remaining: int, bsz: int, buckets) -> int:
    """Group size for the next dispatch: ``bsz`` while it fits; a short
    tail takes the largest batch bucket below ``bsz`` that fits instead of
    padding to ``bsz`` (or all of it, where no bucket fits)."""
    if remaining >= bsz:
        return bsz
    fit = [b for b in buckets if b <= remaining and b < bsz]
    return max(fit) if fit else remaining


# Segment boundaries: break after sentence-final punctuation, or at an
# inter-word silence longer than this.
_SEGMENT_PAUSE_S = 1.0
_SENTENCE_FINAL = (".", "!", "?", "。", "！", "？", "؟")


def _timestamp_mode(return_timestamps) -> Optional[str]:
    """``"word"`` -> word chunks; ``True`` / ``"segment"`` -> segment
    chunks; falsy -> text only."""
    if return_timestamps == "word":
        return "word"
    if return_timestamps is True or return_timestamps == "segment":
        return "segment"
    if return_timestamps:
        raise ValueError(
            f"return_timestamps={return_timestamps!r}: expected False, "
            "True, 'word' or 'segment'")
    return None


def _group_words_into_segments(words: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Group word chunks into HF-style segment chunks: a segment closes
    after sentence-final punctuation or before a pause longer than
    ``_SEGMENT_PAUSE_S``; confidence is the mean of its words'."""
    segments: List[Dict[str, Any]] = []
    cur: List[Dict[str, Any]] = []

    def flush():
        if not cur:
            return
        seg: Dict[str, Any] = {
            "text": "".join(w["text"] for w in cur),
            "timestamp": (cur[0]["timestamp"][0], cur[-1]["timestamp"][1]),
        }
        confs = [w["confidence"] for w in cur if "confidence" in w]
        if confs:
            seg["confidence"] = float(np.mean(confs))
        segments.append(seg)
        cur.clear()

    prev_end: Optional[float] = None
    for w in words:
        start_t = w["timestamp"][0]
        if (cur and prev_end is not None and start_t is not None
                and start_t - prev_end > _SEGMENT_PAUSE_S):
            flush()
        cur.append(w)
        if w["timestamp"][1] is not None:
            prev_end = w["timestamp"][1]
        if w["text"].rstrip().endswith(_SENTENCE_FINAL):
            flush()
    flush()
    return segments


def _fallback_ladder(value) -> Optional[Tuple[float, ...]]:
    """``True`` -> the openai-whisper ladder; a sequence as-is; falsy ->
    no ladder (plain greedy)."""
    if not value:
        return None
    if value is True:
        return (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    return tuple(float(t) for t in value)


def _merge_result_rows(base, sub, idx: Sequence[int]):
    """Overwrite rows ``idx`` of an EngineResult with a retry's rows."""
    def put(a, b):
        if a is None or b is None:
            return a
        a = np.array(a)
        a[list(idx)] = b[: len(idx)]
        return a

    return base._replace(
        tokens=put(base.tokens, sub.tokens),
        num_generated=put(base.num_generated, sub.num_generated),
        sum_logprob=put(base.sum_logprob, sub.sum_logprob),
        align=put(base.align, sub.align),
        token_logprobs=put(base.token_logprobs, sub.token_logprobs),
        no_speech_prob=put(base.no_speech_prob, sub.no_speech_prob),
    )


def _pad_stack(windows, win: int):
    """Zero-pad windows to ``win`` samples and stack them: on their device
    where they are tensors (the long-form windows, sliced on the device),
    else on the host."""
    if any(isinstance(w, torch.Tensor) for w in windows):
        return torch.stack([torch.nn.functional.pad(w, (0, win - w.shape[0]))
                            for w in windows])
    out = np.zeros((len(windows), win), dtype=np.float32)
    for i, w in enumerate(windows):
        out[i, : len(w)] = w
    return out


def _try_load_hf_tokenizer(path: str):
    """The checkpoint's HF tokenizer, or None (no transformers, no files)."""
    import os

    try:
        from transformers import WhisperTokenizer, WhisperTokenizerFast
    except ImportError:
        return None
    if os.path.exists(os.path.join(path, "tokenizer.json")):
        return WhisperTokenizerFast.from_pretrained(path)
    if os.path.exists(os.path.join(path, "vocab.json")):
        return WhisperTokenizer.from_pretrained(path)
    return None
