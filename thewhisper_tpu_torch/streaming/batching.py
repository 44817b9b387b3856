"""Multi-stream batching executor: coalesce session buffers into one decode
(the port's copy of thewhisper_tpu's ``streaming/batching.py``).

The reference server shares ONE pipeline across all sessions, so concurrent
streams interleave audio (``examples/server.py:26-28``, noted in SURVEY 2.4
as a limitation). This package does what that design intended: per-session
``StreamingPipeline`` state machines, with their backend transcription
requests funneled through a ``BatchedTranscriber`` that packs concurrent
buffers into one engine call on the card. A batch of one decodes its
greedy steps through the K3 kernel where the engine packed it; a larger
batch takes the plain step.

The worker thread is the only caller of the pipeline's engine while it
runs; a failure there (a kernel that does not launch, say) is set on
every future of the batch, so each waiting session sees the exception.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np

from thewhisper_tpu_torch.streaming.pipeline import (
    DEFAULTS,
    TranscriptionBackend,
    Word,
    words_from_result,
)


class BatchedTranscriber:
    """Background worker that batches transcription requests.

    Requests arriving within ``max_wait_ms`` of each other (up to
    ``max_batch``) are decoded in a single ``ASRPipeline.transcribe_batch``
    call. Each session gets a :class:`QueuedBackend` handle.
    """

    def __init__(
        self,
        asr_pipeline,
        language: str = DEFAULTS.language,
        max_new_tokens: int = DEFAULTS.max_new_tokens,
        max_batch: int = 8,
        max_wait_ms: float = 10.0,
    ):
        self.pipeline = asr_pipeline
        self.language = language
        self.max_new_tokens = max_new_tokens
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, audio: np.ndarray,
               language: Optional[str] = None) -> Future:
        """``language``: per-request forced language (per-session streams
        in different languages coalesce into ONE decode; the engine builds
        per-row prompts). ``None`` uses the transcriber default."""
        fut: Future = Future()
        if self._stop.is_set():
            fut.set_exception(RuntimeError("transcriber closed"))
            return fut
        self._q.put((audio, fut, language))
        return fut

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=2.0)
        self._drain()

    def _drain(self) -> None:
        """Fail any futures still queued — a blocked ``Future.result()``
        with no timeout would otherwise hang its session thread (and the
        per-session lock it holds) forever."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1].set_exception(RuntimeError("transcriber closed"))

    def _worker(self) -> None:
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                break
            batch = [item]
            # Coalesce whatever arrives within the wait window.
            deadline = self.max_wait_s
            while len(batch) < self.max_batch:
                try:
                    nxt = self._q.get(timeout=deadline)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
            audios = [a for a, _, _ in batch]
            futures = [f for _, f, _ in batch]
            langs = [l for _, _, l in batch]
            try:
                results = self.pipeline.transcribe_batch(
                    audios,
                    return_timestamps="word",
                    generate_kwargs={
                        "language": self.language,
                        "max_new_tokens": self.max_new_tokens,
                        "num_beams": 1,
                    },
                    languages=(langs if any(langs) else None),
                )
            except Exception as e:  # propagate to all waiters
                for f in futures:
                    f.set_exception(e)
                continue
            for i, f in enumerate(futures):
                if i < len(results):
                    f.set_result(results[i])
                else:  # defensive: a short result list must not strand waiters
                    f.set_exception(
                        RuntimeError("transcribe_batch returned too few rows"))
        self._drain()

    def backend(self, language: Optional[str] = None) -> "QueuedBackend":
        return QueuedBackend(self, language=language)


class QueuedBackend(TranscriptionBackend):
    """Session-facing backend that rides the shared batch queue.

    Applies the same gibberish filter and open-end clamp as
    ``LocalWhisperBackend`` (reference ``streaming_pipeline.py:412-426``).
    ``language``: per-session forced language (the desktop client's
    dropdown); ``None`` uses the transcriber default.
    """

    def __init__(self, transcriber: BatchedTranscriber,
                 language: Optional[str] = None):
        self.transcriber = transcriber
        self.language = language

    def transcribe(self, audio: np.ndarray, buffer_start_time: float,
                   sample_rate: int) -> List[Word]:
        result: Dict[str, Any] = self.transcriber.submit(
            audio, language=self.language).result()
        return words_from_result(
            result, len(audio) / sample_rate, buffer_start_time)
