"""Streaming transcription pipeline: VAD gating, rolling buffer, commit logic
(the port's copy of thewhisper_tpu's ``streaming/pipeline.py``).

Behavior-parity port of the reference state machine
(``streaming/streaming_pipeline.py:443-988``). The transcript the user sees
depends on exact constants and quirks, so they are preserved deliberately:

- 2.2 zlib compression-ratio gibberish filter (``:41-43``)
- 2 s minimum buffer before any transcription (``:763-764``)
- rolling window = ``chunk_length_s - 1`` (``:479``)
- trim when buffer > ``window - min_process_chunk_s`` or when speech just
  ended with > 6 s buffered (``:788-796``)
- truncation point: sentence punctuation older than 2 s, else phrase
  punctuation, else the largest inter-word pause, else second-to-last /
  last word end, else ``current_time - 2 * min_process_chunk_s``
  (``:885-937``) — including the reference's falsy-index-0 quirk
- token postprocess: dot fusion, leading-space normalization, " -" -> "-",
  gonNA/gotTA/wanNA fixes, lone The./The/I. drop, committed-word dedup
  (``:824-876``)

The backend seam (``TranscriptionBackend``) matches the reference ABC
(``:51-64``) so fake backends drive the state-machine tests.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import zlib
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from thewhisper_tpu_torch.audio.io import wav_bytes
from thewhisper_tpu_torch.config import StreamingConfig
from thewhisper_tpu_torch.native_lib import RingBuffer
from thewhisper_tpu_torch.streaming.vad import make_vad

logger = logging.getLogger(__name__)

# The state machine's and the backends' defaults, from one source.
DEFAULTS = StreamingConfig()
GIBBERISH_THRESHOLD = DEFAULTS.gibberish_threshold
MAX_WORD_DURATION = DEFAULTS.max_word_duration


def compression_ratio(text: str) -> float:
    raw = text.encode("utf-8")
    return len(raw) / len(zlib.compress(raw))


Word = Dict[str, Any]  # {"text": str, "start": float, "end": float}


def words_from_result(result: Dict[str, Any], audio_duration: float,
                      buffer_start_time: float) -> List[Word]:
    """Pipeline ``{"text","chunks"}`` output -> absolute-time words.

    Shared by the single-session and batched local backends: applies the
    gibberish compression gate and the reference's open-end clamp
    (missing word ends become min(buffer end, start + 1.0 s), reference
    ``streaming_pipeline.py:416-426``).
    """
    if compression_ratio(result["text"]) > GIBBERISH_THRESHOLD:
        return []
    words: List[Word] = []
    for token in result.get("chunks", []):
        start, end = token["timestamp"]
        if end is None:
            if audio_duration - start < MAX_WORD_DURATION:
                end = audio_duration
            else:
                end = start + MAX_WORD_DURATION
        words.append({
            "text": token["text"],
            "start": start + buffer_start_time,
            "end": end + buffer_start_time,
        })
    return words


class TranscriptionBackend(ABC):
    """Turn an audio buffer into absolute-time words."""

    @abstractmethod
    def transcribe(self, audio: np.ndarray, buffer_start_time: float,
                   sample_rate: int) -> List[Word]:
        ...


class LocalWhisperBackend(TranscriptionBackend):
    """Backend on the port's ``ASRPipeline`` (on the card unless
    ``device="cpu"`` rides in ``pipeline_kwargs``).

    Mirrors the reference backend (``streaming_pipeline.py:340-435``):
    greedy word-timestamp transcription with ``max_new_tokens=128``, the
    gibberish filter, and the 1 s open-end clamp.
    """

    def __init__(
        self,
        model,
        model_size: str = "S",
        chunk_length_s: int = int(DEFAULTS.chunk_length_s),
        language: str = DEFAULTS.language,
        max_new_tokens: int = DEFAULTS.max_new_tokens,
        **pipeline_kwargs,
    ):
        from thewhisper_tpu_torch.pipeline import ASRPipeline

        if isinstance(model, ASRPipeline):
            self.asr_pipeline = model
        else:
            # Cross-tick proposal reuse defaults ON for streaming, as in
            # the JAX backend: each tick re-transcribes a rolling buffer
            # that changed by ~0.5 s, so the previous tick's tokens draft
            # the re-decode. A drafted tick asks for word timestamps, so
            # it verifies on the plain decoder even where greedy steps
            # run K3, and is then the slower of the two (PERF.md §5).
            # Pass reuse_previous_tokens=False to force the plain path.
            pipeline_kwargs.setdefault("reuse_previous_tokens", True)
            self.asr_pipeline = ASRPipeline(
                model, model_size=model_size, chunk_length_s=chunk_length_s,
                language=language, **pipeline_kwargs)
        self.chunk_length_s = chunk_length_s
        self.language = language
        self.max_new_tokens = max_new_tokens

    def transcribe(self, audio: np.ndarray, buffer_start_time: float,
                   sample_rate: int) -> List[Word]:
        result = self.asr_pipeline(
            audio,
            return_timestamps="word",
            generate_kwargs={
                "num_beams": 1,
                "max_new_tokens": self.max_new_tokens,
                "language": self.language,
            },
            chunk_length_s=self.chunk_length_s,
        )
        return words_from_result(
            result, len(audio) / sample_rate, buffer_start_time)


class RemoteAPIBackend(TranscriptionBackend):
    """HTTP backend posting 16-bit WAV to a Triton-style gateway.

    Env parity with the reference (``streaming_pipeline.py:166-204``):
    TRITON_URL / TRITON_AUTH_TOKEN / TRITON_MODEL_NAME / TRITON_LANG_ID /
    REQUEST_TIMEOUT_SECONDS.
    """

    def __init__(self, api_url: str, auth_token: str = "", model_name: str = "",
                 lang_id: str = "", request_timeout_s: float = 60.0):
        if not api_url:
            raise ValueError("api_url must be provided for RemoteAPIBackend")
        self.api_url = api_url
        self.auth_token = auth_token
        self.model_name = model_name
        self.lang_id = lang_id
        self.request_timeout_s = request_timeout_s

    @classmethod
    def from_env(cls, api_url: Optional[str] = None,
                 api_auth_token: Optional[str] = None,
                 api_model_name: Optional[str] = None,
                 api_lang_id: Optional[str] = None,
                 request_timeout_s: Optional[float] = None):
        url = api_url or os.getenv("TRITON_URL", "")
        if not url:
            raise ValueError("TRITON_URL / api_url must be set")
        return cls(
            api_url=url,
            auth_token=api_auth_token if api_auth_token is not None
            else os.getenv("TRITON_AUTH_TOKEN", ""),
            model_name=api_model_name if api_model_name is not None
            else os.getenv("TRITON_MODEL_NAME", ""),
            lang_id=api_lang_id if api_lang_id is not None
            else os.getenv("TRITON_LANG_ID", ""),
            request_timeout_s=request_timeout_s if request_timeout_s is not None
            else float(os.getenv("REQUEST_TIMEOUT_SECONDS", "60")),
        )

    def _headers(self) -> Dict[str, str]:
        h: Dict[str, str] = {}
        if self.auth_token:
            h["Authorization"] = f"Bearer {self.auth_token}"
        if self.lang_id:
            h["X-Lang-Id"] = self.lang_id
        if self.model_name:
            h["X-Model-Name"] = self.model_name
        return h

    def _request(self, audio: np.ndarray, sample_rate: int) -> Dict[str, Any]:
        import httpx

        files = {"file": ("chunk.wav", wav_bytes(audio, sample_rate), "audio/wav")}
        resp = httpx.post(self.api_url, headers=self._headers(), files=files,
                          timeout=self.request_timeout_s)
        resp.raise_for_status()
        data = resp.json()
        if isinstance(data, list) and len(data) == 1 and isinstance(data[0], dict):
            data = data[0]
        return data

    def transcribe(self, audio, buffer_start_time, sample_rate):
        raise NotImplementedError(
            "Use RemoteAPITimestampsBackend for word-level timestamps")


class RemoteAPITimestampsBackend(RemoteAPIBackend):
    """Remote backend parsing ``metadata.chunks`` word timestamps.

    Tolerant metadata normalization (dict / list / JSON string,
    reference ``:213-253``) and the same open-end clamp.
    """

    @classmethod
    def _normalize_metadata(cls, metadata) -> Optional[Dict[str, Any]]:
        if metadata is None:
            return None
        if isinstance(metadata, dict):
            return metadata
        if isinstance(metadata, str):
            try:
                return cls._normalize_metadata(json.loads(metadata))
            except json.JSONDecodeError:
                return None
        if isinstance(metadata, list) and metadata:
            for m in metadata:
                if isinstance(m, dict) and "chunks" in m:
                    return m
            for m in metadata:
                if isinstance(m, dict):
                    return m
            for m in metadata:
                if isinstance(m, str):
                    try:
                        loaded = json.loads(m)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(loaded, dict):
                        return loaded
        return None

    @staticmethod
    def _chunk_start(chunk: Dict[str, Any]) -> float:
        ts = chunk.get("timestamp") or chunk.get("timestamps") or chunk.get("time")
        if not ts or len(ts) < 1 or ts[0] is None:
            return 0.0
        try:
            return float(ts[0])
        except Exception:
            return 0.0

    def transcribe(self, audio: np.ndarray, buffer_start_time: float,
                   sample_rate: int) -> List[Word]:
        data = self._request(audio, sample_rate)
        audio_duration = len(audio) / sample_rate
        if audio_duration <= 0:
            return []
        metadata = self._normalize_metadata(data.get("metadata"))
        chunks = metadata.get("chunks") if isinstance(metadata, dict) else None
        if not isinstance(chunks, list) or not chunks:
            logger.warning("No word timestamps in remote response")
            return []

        text = " ".join(str(c.get("text", "")).strip() for c in chunks)
        if text and compression_ratio(text) > GIBBERISH_THRESHOLD:
            return []

        words: List[Word] = []
        for seg in sorted(chunks, key=self._chunk_start):
            ts = seg.get("timestamp") or seg.get("timestamps") or seg.get("time")
            if not ts or len(ts) != 2 or ts[0] is None:
                continue
            start = float(ts[0])
            end = ts[1]
            if end is None:
                if audio_duration - start < MAX_WORD_DURATION:
                    end = audio_duration
                else:
                    end = start + MAX_WORD_DURATION
            words.append({
                "text": seg.get("text", ""),
                "start": buffer_start_time + start,
                "end": buffer_start_time + float(end),
            })
        return words


class StreamingPipeline:
    """Rolling-buffer streaming transcriber with commit/assumption output.

    ``__call__(small_chunk) -> (committed_words, assumption_words)``.
    """

    def __init__(
        self,
        model: Any = "",
        model_size: str = "S",
        chunk_length_s: int = int(DEFAULTS.chunk_length_s),
        min_process_chunk_s: float = DEFAULTS.min_process_chunk_s,
        language: str = DEFAULTS.language,
        backend: Optional[TranscriptionBackend] = None,
        use_remote_api: bool = False,
        api_url: Optional[str] = None,
        api_auth_token: Optional[str] = None,
        api_model_name: Optional[str] = None,
        api_lang_id: Optional[str] = None,
        request_timeout_s: Optional[float] = None,
        sample_rate: int = DEFAULTS.sample_rate,
        use_vad: bool = DEFAULTS.use_vad,
        vad_threshold: float = DEFAULTS.vad_threshold,
        vad_no_speech_chunks: int = DEFAULTS.vad_no_speech_chunks,
        vad_prepend_chunks: int = DEFAULTS.vad_prepend_chunks,
        vad: Any = "auto",
        **backend_kwargs,
    ):
        self.sample_rate = sample_rate
        self.chunk_length_s = float(chunk_length_s)
        self.min_process_chunk_s = float(min_process_chunk_s)
        self.window_size = dataclasses.replace(
            DEFAULTS, chunk_length_s=self.chunk_length_s).window_size_s

        if backend is not None:
            self.backend = backend
        elif use_remote_api:
            self.backend = RemoteAPITimestampsBackend.from_env(
                api_url=api_url, api_auth_token=api_auth_token,
                api_model_name=api_model_name, api_lang_id=api_lang_id,
                request_timeout_s=request_timeout_s)
        else:
            if not isinstance(model, TranscriptionBackend) and model == "":
                raise ValueError("model is required for the local backend")
            self.backend = LocalWhisperBackend(
                model, model_size=model_size, chunk_length_s=chunk_length_s,
                language=language, **backend_kwargs)

        # Rolling transcription state. The audio buffer is the host
        # runtime's ring buffer (native_lib.RingBuffer): O(1) appends
        # instead of the reference's np.concatenate-per-chunk rebuild.
        self._buffer = RingBuffer()
        self.buffer_start_time = 0.0
        self.current_time = 0.0
        self.audio_queue: List[np.ndarray] = []
        self.history: List[List[Word]] = []
        self.need_to_process = False
        self._pending_chunk: Optional[np.ndarray] = None
        self._last_committed_word: Optional[str] = None

        # VAD state.
        self.use_vad = use_vad
        self.vad_threshold = vad_threshold
        self.vad_model = None
        self._no_speech_threshold = vad_no_speech_chunks
        self._prepend_chunks = vad_prepend_chunks
        self._vad_history: List[bool] = []
        self._recent_chunks: List[np.ndarray] = []
        self._in_speech_mode = False
        self._prev_speech_mode = False
        self._vad_buffer = np.array([], dtype=np.float32)
        if use_vad:
            self.vad_model = vad if not isinstance(vad, str) else make_vad(
                vad, sample_rate=sample_rate)

        # Per-stage wall-clock accumulators (aux observability; the
        # reference only tracks total_time_worked on the model wrappers).
        self.stats = {"vad_s": 0.0, "transcribe_s": 0.0,
                      "postprocess_s": 0.0, "chunks_processed": 0,
                      "last_latency_s": 0.0}

    @property
    def current_audio_buffer(self) -> Optional[np.ndarray]:
        """Materialized rolling buffer (read-only view for callers/tests)."""
        if len(self._buffer) == 0:
            return None
        return self._buffer.peek()

    # -- input side ----------------------------------------------------------

    def __call__(self, chunk: np.ndarray) -> Tuple[List[Word], List[Word]]:
        self.add_new_chunk(chunk)
        return self.process_new_chunk()

    def _vad_speech(self, audio: np.ndarray) -> bool:
        """Run the stateful 512-sample VAD over buffered audio."""
        if self.vad_model is None:
            return True
        self._vad_buffer = np.concatenate(
            [self._vad_buffer, np.asarray(audio, np.float32)])
        has_speech = False
        while len(self._vad_buffer) >= 512:
            window, self._vad_buffer = self._vad_buffer[:512], self._vad_buffer[512:]
            if float(self.vad_model(window, self.sample_rate)) > self.vad_threshold:
                has_speech = True
        return has_speech

    def _queue_pending(self) -> None:
        if self._pending_chunk is not None and len(self._pending_chunk) > 0:
            self.audio_queue.append(self._pending_chunk)
            self.need_to_process = True
        self._pending_chunk = None

    def add_new_chunk(self, chunk: np.ndarray) -> None:
        if chunk is None or len(chunk) == 0:
            return
        if not self.use_vad or self.vad_model is None:
            self._append_pending(chunk)
            self._flush_pending_if_ready()
            return

        t0 = time.perf_counter()
        has_speech = self._vad_speech(chunk)
        self.stats["vad_s"] += time.perf_counter() - t0

        self._recent_chunks.append(chunk)
        if len(self._recent_chunks) > self._prepend_chunks:
            self._recent_chunks.pop(0)
        self._vad_history.append(has_speech)
        if len(self._vad_history) > self._no_speech_threshold:
            self._vad_history.pop(0)

        if self._in_speech_mode:
            self._append_pending(chunk)
            recent = self._vad_history[-self._no_speech_threshold:]
            if len(self._vad_history) >= self._no_speech_threshold and not any(recent):
                # Speech ended: flush what we have.
                self._in_speech_mode = False
                self._queue_pending()
        elif has_speech:
            # Speech started: prepend the pre-roll so onsets aren't clipped.
            self._in_speech_mode = True
            preroll = self._recent_chunks[:-1]
            self._pending_chunk = (
                np.concatenate(preroll) if preroll else None)
            self._append_pending(chunk)

        self._flush_pending_if_ready()

    def _append_pending(self, chunk: np.ndarray) -> None:
        if self._pending_chunk is None:
            self._pending_chunk = chunk
        else:
            self._pending_chunk = np.concatenate([self._pending_chunk, chunk])

    def _flush_pending_if_ready(self) -> None:
        if self._pending_chunk is None:
            return
        if len(self._pending_chunk) / self.sample_rate >= self.min_process_chunk_s:
            self._queue_pending()

    # -- processing side -----------------------------------------------------

    def process_new_chunk(self) -> Tuple[List[Word], List[Word]]:
        if not self.audio_queue:
            return [], []

        t_start = time.perf_counter()
        chunk = np.concatenate(self.audio_queue)
        self.audio_queue = []
        self.current_time += len(chunk) / self.sample_rate
        self._buffer.write(chunk)

        if len(self._buffer) < 2.0 * self.sample_rate:
            return [], []

        committed: List[Word] = []
        assumption: List[Word] = []

        if self.need_to_process:
            t0 = time.perf_counter()
            words = self.backend.transcribe(
                audio=self._buffer.peek(),
                buffer_start_time=self.buffer_start_time,
                sample_rate=self.sample_rate,
            )
            self.stats["transcribe_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            words = self._postprocess(words)
            self.stats["postprocess_s"] += time.perf_counter() - t0
            self.stats["chunks_processed"] += 1
            self.need_to_process = False
            assumption = words
            self.history.append(words)

        max_allowed = (self.window_size - self.min_process_chunk_s) * self.sample_rate
        need_trim = len(self._buffer) > max_allowed
        truncation_time: Optional[float] = None

        if (self._prev_speech_mode and not self._in_speech_mode
                and len(self._buffer) > 6 * self.sample_rate):
            need_trim = True
            truncation_time = self.current_time
        self._prev_speech_mode = self._in_speech_mode

        if need_trim:
            final = self.history[-1] if self.history else []
            if truncation_time is None:
                truncation_time = self._truncation_time(final, need_trim)
            if truncation_time is not None:
                self._trim_buffer(truncation_time)
                committed = [w for w in final if w["start"] < truncation_time]
                assumption = [w for w in final if w["start"] >= truncation_time]
                if committed:
                    self._last_committed_word = committed[-1]["text"].strip()

        self.stats["last_latency_s"] = time.perf_counter() - t_start
        return committed, assumption

    # -- heuristics ----------------------------------------------------------

    def _postprocess(self, words: List[Word]) -> List[Word]:
        out: List[Word] = []
        for w in words:
            text = w["text"]
            # Dot-only tokens fuse into the previous word.
            if text.strip() and all(c in (" ", ".") for c in text):
                if out:
                    out[-1]["text"] += text.strip()
                continue
            out.append(dict(w))

        for w in out:
            if w["text"] and not w["text"].startswith(" "):
                w["text"] = " " + w["text"]
            if w["text"].startswith(" -"):
                w["text"] = w["text"].replace(" -", "-")
            for bad, good in (("gonNA", "gonna"), ("gotTA", "gotta"),
                              ("wanNA", "wanna")):
                w["text"] = w["text"].replace(bad, good)

        # A lone hallucinated "The."/"The"/"I." is dropped wholesale.
        if len(out) == 1 and out[0]["text"].strip() in ("The.", "The", "I."):
            out = []

        # Drop a duplicate of the last committed word at the buffer seam.
        if self._last_committed_word is not None and out:
            if out[0]["text"].strip().lower() == self._last_committed_word.lower():
                out = out[1:]
        return out

    def _truncation_time(self, words: List[Word],
                         need_trim: bool) -> Optional[float]:
        last_sentence_idx = None
        last_phrase_idx = None
        max_pause_idx = None
        max_pause = 0.0
        prev_end = 0.0

        for i, w in enumerate(words):
            text = w["text"].strip()
            end = w["end"]
            if text.endswith((".", "?", "!")) and end < self.current_time - 2.0:
                last_sentence_idx = i
            if text.endswith((",", ";", ":")) and end < self.current_time - 2.0:
                last_phrase_idx = i
            if w["start"] - prev_end >= max_pause:
                max_pause = w["start"] - prev_end
                max_pause_idx = i - 1
            prev_end = w["end"]

        # NOTE: truthiness (not `is not None`) on the punctuation indices is
        # intentional reference parity (streaming_pipeline.py:919-922): a
        # sentence end at index 0 falls through to the next heuristic.
        if last_sentence_idx:
            return words[last_sentence_idx]["end"]
        if last_phrase_idx:
            return words[last_phrase_idx]["end"]
        if max_pause_idx is not None and max_pause_idx >= 0 and need_trim:
            return words[max_pause_idx]["end"]
        if len(words) >= 2 and need_trim:
            return words[-2]["end"]
        if len(words) == 1 and need_trim:
            return words[0]["end"]
        if need_trim:
            return self.current_time - self.min_process_chunk_s * 2
        return None

    def _trim_buffer(self, truncation_time: float) -> None:
        delta = truncation_time - self.buffer_start_time
        if delta <= 0:
            return
        self._buffer.discard(int(delta * self.sample_rate))
        self.buffer_start_time = truncation_time
        new_history = []
        for words in self.history:
            kept = [w for w in words if w["start"] >= truncation_time]
            if kept:
                new_history.append(kept)
        self.history = new_history

    def clear(self) -> None:
        self._buffer.clear()
        self._pending_chunk = None
        self.buffer_start_time = 0.0
        self.current_time = 0.0
        self.audio_queue = []
        self.need_to_process = False
        self.history = []
        self._last_committed_word = None
        self._vad_history = []
        self._recent_chunks = []
        self._in_speech_mode = False
        self._prev_speech_mode = False
        self._vad_buffer = np.array([], dtype=np.float32)
        if self.vad_model is not None:
            self.vad_model.reset_states()
