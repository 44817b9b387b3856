"""Build and run the REST streaming server (the port's counterpart of
``examples/server.py``). Start it with::

    ASR_MODEL=/path/to/checkpoint python -m thewhisper_tpu_torch.server

Environment (the same variables as the JAX example and the reference):
    ASR_STREAMING_HOST (default 127.0.0.1), ASR_STREAMING_PORT (default 8800)
    CHUNK_SECONDS (default 10)
    ASR_BACKEND_TYPE: "whisper" for the remote Triton gateway; anything
        else (default) serves the local engine
    TRITON_URL / TRITON_AUTH_TOKEN / TRITON_MODEL_NAME / TRITON_LANG_ID
    ASR_MODEL: HF checkpoint directory for the local engine (read with the
        ``safetensors`` package)
    ASR_MODEL_SIZE ("S" int8, "S-legacy", "XL32" f32; any other name,
        "XL" and "S+" among them, bf16), ASR_DRAFT, ASR_REUSE_PREV
        (default 1), ASR_WARMUP (default 1; 0 skips the warm-up)
    ASR_LATENCY_BUCKETS: comma-separated seconds (e.g. "2.5,5"), the
        pipeline's ``latency_buckets``: a short early-stream buffer encodes
        at the smallest bucket that holds it; off by default

Every session has its own state machine; the decode requests of all
sessions are batched into single engine calls on the card (or on the CPU
when ``build_server`` is asked for it).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from thewhisper_tpu_torch.config import SAMPLE_RATE, ServerConfig
from thewhisper_tpu_torch.engine.engine import _bucket_batch
from thewhisper_tpu_torch.server.http import SessionManager, StreamingServer
from thewhisper_tpu_torch.streaming.batching import BatchedTranscriber


def warm_up(asr, chunk_length_s: float, max_new_tokens: int = 128,
            max_batch: int = 8) -> None:
    """Make the engine's decode programs for every batch bucket that a
    coalesced batch of 1 to ``max_batch`` windows falls in, at the mel
    frames of every latency bucket of the pipeline, with word timestamps,
    as the transcriber calls it (``engine.warmup``: on the card each
    captures its CUDA graph, so no request pays a capture, and the engine
    keeps them all), and with cross-tick reuse on the proposal-token
    programs its drafted ticks run (``proposals=True``, as JAX's example
    server warms them); then one ``transcribe_batch`` a latency bucket, of
    a full rolling window or a buffer just inside the bucket, runs the rest
    of the path (each bucket's featurizer, DTW) once."""
    engine = asr.engine
    buckets = sorted({_bucket_batch(n, engine.batch_buckets)
                      for n in range(1, max_batch + 1)})
    reuse = {"proposals": True} if getattr(asr, "_reuse_previous", False) else {}
    for b in asr.latency_buckets:
        engine.warmup(asr._featurizer_for(b).num_mel_frames(), batches=buckets,
                      max_new_tokens=max_new_tokens, timestamps=True, **reuse)
    for b in asr.latency_buckets:
        seconds = chunk_length_s - 1 if b >= chunk_length_s else b - 0.1
        one = np.zeros(int(seconds * SAMPLE_RATE), np.float32)
        asr.transcribe_batch([one], return_timestamps="word",
                             generate_kwargs={"max_new_tokens": max_new_tokens,
                                              "language": "en"})


def serve_pipeline(asr, config: ServerConfig, warmup: bool = True,
                   max_batch: int = 8, max_new_tokens: int = 128,
                   ) -> Tuple[StreamingServer, BatchedTranscriber]:
    """A server whose sessions share ``asr`` (a port ``ASRPipeline``)
    through one :class:`BatchedTranscriber`. On the card the kernels are
    built here, before the worker thread takes a request. The caller
    starts the server and closes the transcriber."""
    device = asr.engine.device
    if device.type == "cuda":
        from thewhisper_tpu_torch.ops import _build

        _build.lib()
    if warmup:
        warm_up(asr, config.chunk_length_s, max_new_tokens, max_batch)
    transcriber = BatchedTranscriber(asr, max_batch=max_batch,
                                     max_new_tokens=max_new_tokens)
    manager = SessionManager(transcriber.backend,
                             chunk_length_s=config.chunk_length_s,
                             backend_type=device.type)
    return StreamingServer(manager, config), transcriber


def build_server(device="cuda", config: Optional[ServerConfig] = None,
                 ) -> Tuple[StreamingServer, Optional[BatchedTranscriber]]:
    """The server ``python -m thewhisper_tpu_torch.server`` runs, built from
    the environment; the transcriber is None for the remote backend."""
    config = config or ServerConfig.from_env()
    if os.getenv("ASR_BACKEND_TYPE", "cuda").lower() == "whisper":
        from thewhisper_tpu_torch.streaming.pipeline import (
            RemoteAPITimestampsBackend,
        )

        manager = SessionManager(RemoteAPITimestampsBackend.from_env,
                                 chunk_length_s=config.chunk_length_s,
                                 backend_type="whisper")
        return StreamingServer(manager, config), None
    model = os.getenv("ASR_MODEL")
    if not model:
        raise SystemExit("set ASR_MODEL to an HF checkpoint directory")
    raw = os.getenv("ASR_LATENCY_BUCKETS", "")
    try:
        buckets = [float(b) for b in raw.split(",") if b.strip()]
    except ValueError:
        raise SystemExit(
            f"ASR_LATENCY_BUCKETS must be comma-separated seconds "
            f"(e.g. \"2.5,5\"), got: {raw!r}")
    from thewhisper_tpu_torch.pipeline import ASRPipeline

    # ASR_REUSE_PREV defaults on: the previous tick's tokens draft each
    # re-decode. Rows associate by batch position, so a change in the
    # coalesced batch only costs verify misses, never content.
    asr = ASRPipeline(
        model, chunk_length_s=config.chunk_length_s,
        model_size=os.getenv("ASR_MODEL_SIZE") or None,
        draft=os.getenv("ASR_DRAFT") or None,
        latency_buckets=buckets or None,
        reuse_previous_tokens=os.getenv("ASR_REUSE_PREV", "1") == "1",
        device=device)
    return serve_pipeline(asr, config,
                          warmup=os.getenv("ASR_WARMUP", "1") != "0")


def main() -> None:
    server, transcriber = build_server()
    print(f"Server started on {server.config.host}:{server.port} "
          f"(backend {server.manager.backend_type})", flush=True)
    try:
        server.serve_forever()
    finally:
        if transcriber is not None:
            transcriber.close()
