"""REST streaming server on the Python stdlib HTTP stack (the port's copy
of thewhisper_tpu's ``server/http.py``).

Route and payload parity with the reference FastAPI server
(``examples/server.py:118-163``) so the Electron client works unchanged:

- ``POST /session/create/``                      -> ``{"session_id": ...}``
- ``POST /session/{id}/add_chunk?audio_data=b64`` (base64 float32 little-endian)
- ``POST /session/{id}/process``                 -> ``{"words", "uncommited_words"}``
- ``POST /session/{id}/clear``
- ``POST /session/{id}/end``

Improvements over the reference (SURVEY section 7, stage 7): each session
owns its own ``StreamingPipeline`` state machine (the reference shares one
pipeline across sessions, interleaving audio), and all sessions' decode
requests are coalesced by ``BatchedTranscriber`` into batched engine calls
on the card. ``/health`` reports the manager's ``backend_type``: ``"cuda"``
for the local engine (the JAX server reports ``"tpu"``).
CORS ``*`` and the ``/tmp/asr_streaming_server.pid`` pidfile are preserved.
"""

from __future__ import annotations

import base64
import json
import os
import secrets
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from thewhisper_tpu_torch.config import LANGUAGES, ServerConfig
from thewhisper_tpu_torch.streaming.pipeline import (
    DEFAULTS,
    StreamingPipeline,
    TranscriptionBackend,
)


class SessionNotFound(KeyError):
    """Unknown/expired session id — the only KeyError the handler maps
    to 404 (internal KeyErrors must surface as 500s)."""


class BadRequest(ValueError):
    """Client-side input error detected before any work (unknown language
    code at session create) -> 400. Malformed audio payloads keep the
    reference's 500 (its FastAPI endpoints surface them as plain
    exceptions)."""


class ServerFull(RuntimeError):
    """Session table is full of ACTIVE sessions (every candidate victim's
    lock is held by a request thread) — mapped to 503 so the client gets a
    capacity signal instead of a silently-evicted live session."""


class SessionManager:
    """Per-session streaming pipelines over a shared backend factory.

    Bounded: sessions idle longer than ``session_ttl_s`` are evicted, and
    at ``max_sessions`` the least-recently-used one is dropped — abandoned
    clients (crashed before ``/end``) no longer leak pipeline state
    (ring buffer, VAD state, history) forever.
    """

    def __init__(self, backend_factory: Callable[[], TranscriptionBackend],
                 chunk_length_s: int = int(DEFAULTS.chunk_length_s),
                 use_vad: bool = DEFAULTS.use_vad,
                 min_process_chunk_s: float = DEFAULTS.min_process_chunk_s,
                 max_sessions: int = 64, session_ttl_s: float = 600.0,
                 backend_type: str = "cuda"):
        self.backend_factory = backend_factory
        self.backend_type = backend_type
        self.chunk_length_s = chunk_length_s
        self.use_vad = use_vad
        self.min_process_chunk_s = min_process_chunk_s
        self.max_sessions = max_sessions
        self.session_ttl_s = session_ttl_s
        self._sessions: Dict[str, StreamingPipeline] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._last_seen: Dict[str, float] = {}
        self._global = threading.Lock()

    def _evict_locked(self) -> None:
        now = time.monotonic()
        expired = [sid for sid, t in self._last_seen.items()
                   if now - t > self.session_ttl_s]
        for sid in expired:
            self._sessions.pop(sid, None)
            self._locks.pop(sid, None)
            self._last_seen.pop(sid, None)
        while len(self._sessions) >= self.max_sessions:
            # LRU victim — but never a session a request thread is inside
            # (its per-session lock is held): evicting one mid-request
            # turned a live stream into 404s with no capacity signal.
            idle = [sid for sid in self._last_seen
                    if not self._locks[sid].locked()]
            if not idle:
                raise ServerFull(
                    f"all {self.max_sessions} sessions are active")
            oldest = min(idle, key=self._last_seen.get)
            self._sessions.pop(oldest, None)
            self._locks.pop(oldest, None)
            self._last_seen.pop(oldest, None)

    def create(self, language: Optional[str] = None) -> str:
        """``language``: optional forced language for this session (the
        desktop client's dropdown). Applied when the backend supports a
        per-session language (``QueuedBackend``); other backends keep
        their own configuration (remote gateways use TRITON_LANG_ID).

        An unknown code raises ValueError -> HTTP 400 HERE, not later:
        inside the batched coalescer a bad prompt language would fail
        the whole coalesced batch and 500 every concurrent session's
        request riding it."""
        if language is not None:
            if language not in LANGUAGES:
                raise BadRequest(f"unknown language code: {language!r}")
        session_id = secrets.token_urlsafe(16)
        backend = self.backend_factory()
        if language and hasattr(backend, "language"):
            backend.language = language
        pipe = StreamingPipeline(
            backend=backend,
            chunk_length_s=self.chunk_length_s,
            min_process_chunk_s=self.min_process_chunk_s,
            use_vad=self.use_vad,
        )
        with self._global:
            self._evict_locked()
            self._sessions[session_id] = pipe
            self._locks[session_id] = threading.Lock()
            self._last_seen[session_id] = time.monotonic()
        return session_id

    def _acquire(self, session_id: str) -> Tuple[StreamingPipeline, threading.Lock]:
        """Look up a session and ACQUIRE its lock atomically with table
        membership (caller releases). Taking the lock under ``_global``
        closes the window where eviction saw the lock unlocked between a
        lookup and the caller's ``with lock:`` — the last way a live
        request's session could be yanked mid-flight. If the lock is
        busy, wait OUTSIDE ``_global`` (never block the table on a long
        decode), then re-verify membership: the session may have been
        ended or idle-evicted while this request queued."""
        while True:
            with self._global:
                pipe = self._sessions.get(session_id)
                lock = self._locks.get(session_id)
                if pipe is None:
                    raise SessionNotFound(session_id)
                self._last_seen[session_id] = time.monotonic()
                if lock.acquire(blocking=False):
                    return pipe, lock
            lock.acquire()                     # wait for the current request
            with self._global:
                if self._sessions.get(session_id) is pipe:
                    self._last_seen[session_id] = time.monotonic()
                    return pipe, lock
            lock.release()
            raise SessionNotFound(session_id)

    def add_chunk(self, session_id: str, audio: np.ndarray) -> None:
        pipe, lock = self._acquire(session_id)
        try:
            pipe.add_new_chunk(audio)
        finally:
            lock.release()

    def process(self, session_id: str):
        pipe, lock = self._acquire(session_id)
        try:
            return pipe.process_new_chunk()
        finally:
            lock.release()

    def clear(self, session_id: str) -> None:
        pipe, lock = self._acquire(session_id)
        try:
            pipe.clear()
        finally:
            lock.release()

    def end(self, session_id: str) -> None:
        with self._global:
            self._sessions.pop(session_id, None)
            self._locks.pop(session_id, None)
            self._last_seen.pop(session_id, None)

    def cleanup(self) -> None:
        with self._global:
            self._sessions.clear()
            self._locks.clear()
            self._last_seen.clear()

    @property
    def n_sessions(self) -> int:
        with self._global:
            return len(self._sessions)

    def stats(self) -> Dict[str, Any]:
        """Aggregated per-stage timing over live sessions (observability)."""
        with self._global:
            sessions = dict(self._sessions)
        per_session = {}
        totals = {"vad_s": 0.0, "transcribe_s": 0.0, "postprocess_s": 0.0,
                  "chunks_processed": 0}
        for sid, pipe in sessions.items():
            st = dict(getattr(pipe, "stats", {}))
            per_session[sid] = st
            for k in totals:
                totals[k] += st.get(k, 0)
        return {"sessions": len(sessions), "totals": totals,
                "per_session": per_session}


def _make_handler(manager: SessionManager):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # A response goes out as two writes (headers, then body); with
        # Nagle on, the body waits for the client's delayed ACK of the
        # headers, about 40 ms a response on a keep-alive connection.
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.end_headers()
            self.wfile.write(body)

        def do_OPTIONS(self):  # CORS preflight
            self._send(200, {})

        def do_GET(self):
            path = urlparse(self.path).path
            if path in ("/health", "/health/"):
                self._send(200, {"status": "ok",
                                 "sessions": manager.n_sessions,
                                 "backend": manager.backend_type})
            elif path in ("/stats", "/stats/"):
                self._send(200, manager.stats())
            else:
                self._send(404, {"detail": "not found"})

        def do_POST(self):
            parsed = urlparse(self.path)
            parts = [p for p in parsed.path.split("/") if p]
            # Drain the request body up front: with HTTP/1.1 keep-alive a
            # handler that responds without consuming the body leaves its
            # bytes on the socket, which the next request parse chokes on
            # (400 + dropped connection for the client thereafter).
            length = int(self.headers.get("Content-Length", 0) or 0)
            self._body = self.rfile.read(length) if length else b""
            try:
                if parts == ["session", "create"]:
                    qs = parse_qs(parsed.query)
                    language = (qs.get("language") or [None])[0] or None
                    self._send(200, {"session_id": manager.create(
                        language=language)})
                    return
                if len(parts) == 3 and parts[0] == "session":
                    sid, action = parts[1], parts[2]
                    if action == "add_chunk":
                        audio = self._read_audio(parsed)
                        manager.add_chunk(sid, audio)
                        self._send(200, {"status": "success"})
                    elif action == "process":
                        words, uncommited = manager.process(sid)
                        self._send(200, {
                            "words": words, "uncommited_words": uncommited})
                    elif action == "clear":
                        manager.clear(sid)
                        self._send(200, {"status": "success"})
                    elif action == "end":
                        manager.end(sid)
                        self._send(200, {"status": "success"})
                    else:
                        self._send(404, {"detail": "unknown action"})
                    return
                self._send(404, {"detail": "not found"})
            except SessionNotFound as e:
                self._send(404, {"detail": f"Session {e.args[0]} not found"})
            except ServerFull as e:
                self._send(503, {"detail": str(e)})
            except BadRequest as e:
                self._send(400, {"detail": str(e)})
            except Exception as e:  # parity: reference returns 500 + detail
                self._send(500, {"detail": str(e)})

        def _read_audio(self, parsed) -> np.ndarray:
            # Reference passes base64 float32 as the ``audio_data`` query
            # param (server.py:135-144); JSON body is accepted as well.
            qs = parse_qs(parsed.query)
            b64: Optional[str] = None
            if "audio_data" in qs:
                b64 = qs["audio_data"][0]
            elif self._body:
                try:
                    payload = json.loads(self._body)
                    b64 = payload.get("audio_data")
                except Exception:
                    b64 = None
            if not b64:
                raise ValueError("audio_data missing")
            # parse_qs turns an unescaped '+' into ' '; map it back and
            # validate so corrupted payloads fail loudly instead of
            # bit-shifting into garbage audio with status "success".
            b64 = b64.replace(" ", "+")
            return np.frombuffer(
                base64.b64decode(b64, validate=True), dtype=np.float32)

    return Handler


class StreamingServer:
    """Threaded HTTP server wrapper with pidfile + signal cleanup."""

    def __init__(self, manager: SessionManager,
                 config: Optional[ServerConfig] = None):
        self.manager = manager
        self.config = config or ServerConfig.from_env()
        self.httpd = ThreadingHTTPServer(
            (self.config.host, self.config.port), _make_handler(manager))

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self) -> None:
        with open(self.config.pidfile, "w") as f:
            f.write(str(os.getpid()))

        def _shutdown(sig, frame):
            self.manager.cleanup()
            if os.path.exists(self.config.pidfile):
                os.remove(self.config.pidfile)
            raise SystemExit(0)

        signal.signal(signal.SIGINT, _shutdown)
        signal.signal(signal.SIGTERM, _shutdown)
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.manager.cleanup()
