"""The port's REST server (``thewhisper_tpu_torch.server``) against the JAX
package's: the same request script, on the same fake backend, gets the
same status codes and payloads from both (session ids and timings aside),
over stdlib HTTP. Then the session table's bounds, the batching
coalescer, and the entry point's ``build_server`` on the tiny checkpoint.
"""

import base64
import http.client
import json
import threading
import time
from urllib.parse import quote

import numpy as np
import pytest
import torch

import thewhisper_tpu.server.http as jax_http
import thewhisper_tpu_torch.server.http as http_mod
from thewhisper_tpu.config import ServerConfig as JaxServerConfig
from thewhisper_tpu.streaming.batching import BatchedTranscriber as JaxBatched
from thewhisper_tpu_torch.config import ServerConfig
from thewhisper_tpu_torch.streaming.batching import BatchedTranscriber

PACKAGES = {"jax": (jax_http, JaxServerConfig, JaxBatched),
            "torch": (http_mod, ServerConfig, BatchedTranscriber)}


class FakeBackend:
    def transcribe(self, audio, buffer_start_time, sample_rate):
        n = int(len(audio) / sample_rate / 0.5)
        return [{"text": f" w{i}" + ("." if i % 3 == 2 else ""),
                 "start": buffer_start_time + 0.5 * i,
                 "end": buffer_start_time + 0.5 * (i + 1)} for i in range(n)]


def _b64(audio: np.ndarray) -> str:
    return base64.b64encode(audio.astype(np.float32).tobytes()).decode()


class Client:
    """One keep-alive connection; every response as (status, payload)."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def __call__(self, method, path, body=None, headers=None):
        self.conn.request(method, path, body=body, headers=headers or {})
        r = self.conn.getresponse()
        data = r.read()
        assert r.getheader("Access-Control-Allow-Origin") == "*"
        return r.status, json.loads(data)

    def close(self):
        self.conn.close()


def _serve(pkg, factory, **kw):
    mod, config_cls, _ = pkg
    manager = mod.SessionManager(factory, chunk_length_s=4, use_vad=False, **kw)
    srv = mod.StreamingServer(manager, config_cls(host="127.0.0.1", port=0))
    srv.start_background()
    return srv


def _script(port: int, seed: int):
    """The Electron client's calls and every error route; session ids are
    replaced by their order of creation."""
    rng = np.random.default_rng(seed)
    c = Client(port)
    out, sids = [], []

    def call(method, template, body=None, headers=None):
        path = template
        for i, sid in enumerate(sids):
            path = path.replace(f"<{i}>", sid)
        status, payload = c(method, path, body, headers)
        if isinstance(payload, dict) and "session_id" in payload:
            sids.append(payload.pop("session_id"))
        if isinstance(payload, dict) and "detail" in payload:
            for i, sid in enumerate(sids):
                payload["detail"] = payload["detail"].replace(sid, f"<{i}>")
        out.append((method, template.split("?")[0], status, payload))

    try:
        call("OPTIONS", "/session/create/")
        call("POST", "/session/create/")
        call("POST", "/session/create/?language=fr")
        call("POST", "/session/create/?language=xx")
        for i in range(16):
            chunk = 0.1 * rng.standard_normal(3200)
            call("POST", f"/session/<0>/add_chunk?audio_data={quote(_b64(chunk))}")
            call("POST", "/session/<0>/process")
            if i % 4 == 0:
                call("POST", "/session/<1>/process")
        # JSON bodies and bodies the route ignores, on the same connection.
        body = json.dumps({"audio_data": _b64(np.zeros(1600))}).encode()
        for _ in range(3):
            call("POST", "/session/<1>/add_chunk", body,
                 {"Content-Type": "application/json"})
        call("POST", "/session/<1>/process", b'{"ignored": 1}')
        call("POST", "/session/<0>/add_chunk")
        call("POST", "/session/<0>/add_chunk?audio_data=ab%25cd==")
        call("POST", "/session/<0>/add_chunk", b"not json")
        call("POST", "/session/<0>/nope")
        call("POST", "/nope")
        call("GET", "/nope")
        call("GET", "/health")
        call("POST", "/session/<0>/clear")
        call("POST", "/session/<0>/process")
        call("POST", "/session/<0>/end")
        call("POST", "/session/<0>/process")
        call("POST", "/session/unknown/add_chunk?audio_data=AAAAAA==")
        status, stats = c("GET", "/stats/")
        out.append(("GET", "/stats/", status, {
            "sessions": stats["sessions"],
            "chunks_processed": stats["totals"]["chunks_processed"],
            "per_session": sorted(
                (s["chunks_processed"], sorted(s))
                for s in stats["per_session"].values())}))
    finally:
        c.close()
    return out


def test_http_payloads_match_jax():
    """Lifecycle, isolation, keep-alive with unread and JSON bodies, bad and
    malformed requests, /health and /stats: JAX's statuses and payloads,
    except /health's backend ("cuda" where JAX says "tpu")."""
    runs = {}
    for name, pkg in PACKAGES.items():
        srv = _serve(pkg, FakeBackend)
        try:
            runs[name] = _script(srv.port, seed=3)
        finally:
            srv.shutdown()
    ours, ref = runs["torch"], runs["jax"]
    health = [i for i, r in enumerate(ours) if r[1] == "/health"]
    assert [ours[i][3].pop("backend") for i in health] == ["cuda"]
    assert [ref[i][3].pop("backend") for i in health] == ["tpu"]
    assert ours == ref
    statuses = {r[2] for r in ours}
    assert statuses == {200, 400, 404, 500}
    words = [w for r in ours if r[1].endswith("/process") and r[2] == 200
             for w in r[3]["words"]]
    assert words and all(set(w) == {"text", "start", "end"} for w in words)


def _manager_sequence(pkg):
    """LRU and TTL eviction, active sessions never evicted, a full table of
    active sessions refused, and an end while a request waits."""
    mod = pkg[0]
    m = mod.SessionManager(FakeBackend, chunk_length_s=4, use_vad=False,
                           max_sessions=3, session_ttl_s=1000.0)
    log = []
    sids = [m.create() for _ in range(3)]
    m.process(sids[1])
    m.process(sids[2])
    sids.append(m.create())                  # evicts sids[0], the LRU
    log.append([s in m._sessions for s in sids])
    with pytest.raises(mod.SessionNotFound):
        m.process(sids[0])
    m._locks[sids[1]].acquire()              # sids[1] is LRU but active
    try:
        sids.append(m.create())
        log.append([s in m._sessions for s in sids])
        for s in (sids[3], sids[4]):
            m._locks[s].acquire()
        try:
            with pytest.raises(mod.ServerFull):
                m.create()
            log.append(m.n_sessions)
        finally:
            for s in (sids[3], sids[4]):
                m._locks[s].release()
    finally:
        m._locks[sids[1]].release()
    pipe, lock = m._acquire(sids[1])         # a request holds the session
    errors = []

    def late_request():
        try:
            m.add_chunk(sids[1], np.zeros(100, np.float32))
        except mod.SessionNotFound:
            errors.append("not found")

    t = threading.Thread(target=late_request)
    t.start()
    time.sleep(0.1)
    m.end(sids[1])
    lock.release()
    t.join(timeout=10)
    assert not t.is_alive()
    log.append(errors)
    m.session_ttl_s = 0.0
    m._last_seen = {k: -1e9 for k in m._last_seen}
    m.create()
    log.append(m.n_sessions)
    return log


def test_session_bounds_match_jax():
    assert _manager_sequence(PACKAGES["torch"]) == _manager_sequence(
        PACKAGES["jax"]) == [[False, True, True, True],
                             [False, True, False, True, True], 3,
                             ["not found"], 1]


class FakePipeline:
    """Records each ``transcribe_batch``; raises when asked to. A row's
    word comes from its own request (its language), not from its place in
    the batch, so concurrent requests give the same words in any order."""

    def __init__(self, fail: bool = False):
        self.calls, self.fail = [], fail

    def transcribe_batch(self, audios, return_timestamps="word",
                         generate_kwargs=None, languages=None):
        self.calls.append((len(audios), languages, dict(generate_kwargs)))
        if self.fail:
            raise RuntimeError("kernel launch failed")
        langs = languages or [None] * len(audios)
        return [{"text": f" w{lang}", "chunks": [
            {"text": f" w{lang}", "timestamp": (0.5, None)}]} for lang in langs]


def _coalesce(pkg):
    """Three requests with per-session languages inside one wait window,
    then three sessions' backends at once. The first three are submitted
    in order: their call is returned as it is. The concurrent three reach
    the queue in the scheduler's order, and under load may split into two
    calls: of them, only what no order changes is returned (their rows in
    all, the multiset of their languages, the distinct generate_kwargs of
    their calls, their words sorted)."""
    pipe = FakePipeline()
    bt = pkg[2](pipe, language="en", max_batch=4, max_wait_ms=200.0)
    try:
        a = np.zeros(8000, np.float32)
        futures = [bt.submit(a, language="fr"), bt.submit(a, language="de"),
                   bt.submit(a)]
        results = [f.result(timeout=10) for f in futures]
        words = []
        threads = [threading.Thread(target=lambda b=b: words.append(
            b.transcribe(np.zeros(16000, np.float32), 10.0, 16000)))
            for b in (bt.backend(), bt.backend("de"), bt.backend())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    finally:
        bt.close()
    first, rest = pipe.calls[0], pipe.calls[1:]
    langs = [lang for n, row_langs, _ in rest for lang in (row_langs or [None] * n)]
    concurrent = (sum(n for n, _, _ in rest), sorted(langs, key=repr),
                  sorted({repr(kwargs) for _, _, kwargs in rest}))
    return first, results, concurrent, sorted(map(repr, words))


def test_batched_transcriber_matches_jax():
    """Per-session languages coalesce into one call with per-row prompts;
    open word ends are clamped against the buffer's end."""
    ours, ref = _coalesce(PACKAGES["torch"]), _coalesce(PACKAGES["jax"])
    assert repr(ours) == repr(ref)
    kwargs = {"language": "en", "max_new_tokens": 128, "num_beams": 1}
    assert ours[0] == (3, ["fr", "de", None], kwargs)
    assert ours[2][:2] == (3, ["de", None, None])
    assert ours[2][2] == [repr(kwargs)]
    assert ours[3] == sorted(repr([{"text": f" w{lang}", "start": 10.5, "end": 11.0}])
                             for lang in ("de", None, None))


def test_a_failed_batch_reaches_every_session_as_http_500():
    """An engine failure in the worker thread (a kernel that does not
    launch) is set on every future of the batch: each waiting session's
    ``process`` answers 500 with the error, and the server goes on."""
    pipe = FakePipeline(fail=True)
    bt = BatchedTranscriber(pipe, max_batch=4, max_wait_ms=200.0)
    srv = _serve(PACKAGES["torch"], bt.backend)
    try:
        clients = [Client(srv.port) for _ in range(2)]
        sids = [c("POST", "/session/create/")[1]["session_id"] for c in clients]
        body = json.dumps({"audio_data": _b64(np.full(32000, 0.1))}).encode()
        for c, sid in zip(clients, sids):
            assert c("POST", f"/session/{sid}/add_chunk", body)[0] == 200
        got = []
        threads = [threading.Thread(target=lambda c=c, s=s: got.append(
            c("POST", f"/session/{s}/process"))) for c, s in zip(clients, sids)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert got == [(500, {"detail": "kernel launch failed"})] * 2
        assert clients[0]("GET", "/health")[0] == 200
        for c in clients:
            c.close()
    finally:
        srv.shutdown()
        bt.close()
    assert sum(n for n, _, _ in pipe.calls) == 2


def test_server_config_from_env_matches_jax(monkeypatch):
    import dataclasses

    from thewhisper_tpu.config import StreamingConfig as JaxStreamingConfig
    from thewhisper_tpu_torch.config import StreamingConfig

    assert dataclasses.asdict(StreamingConfig()) == dataclasses.asdict(
        JaxStreamingConfig())
    assert StreamingConfig().window_size_s == JaxStreamingConfig().window_size_s
    for env in ({}, {"ASR_STREAMING_HOST": "0.0.0.0", "ASR_STREAMING_PORT": "9",
                     "CHUNK_SECONDS": "15"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert dataclasses.asdict(ServerConfig.from_env()) == dataclasses.asdict(
            JaxServerConfig.from_env())


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    import sys

    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    sys.path.insert(0, "tools")
    from make_tiny_checkpoint import make_checkpoint

    return make_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny"), seed=3)


def _drive(port: int, chunks, barrier=None):
    """One session: create, add_chunk + process per chunk, end. Returns
    the words of every process call."""
    c = Client(port)
    try:
        status, payload = c("POST", "/session/create/")
        assert status == 200
        sid, ticks = payload["session_id"], []
        for chunk in chunks:
            path = f"/session/{sid}/add_chunk?audio_data={quote(_b64(chunk))}"
            assert c("POST", path)[0] == 200
            if barrier is not None:
                barrier.wait(timeout=60)
            status, payload = c("POST", f"/session/{sid}/process")
            assert status == 200, payload
            ticks.append([payload["words"], payload["uncommited_words"]])
        assert c("POST", f"/session/{sid}/end")[0] == 200
        return ticks
    finally:
        c.close()


def _speech(seconds: float, seed: int) -> list:
    """Formant speech the neural VAD passes, in 0.1 s chunks."""
    from thewhisper_tpu.streaming.vad_corpus import synth_speech

    a, _ = synth_speech(np.random.default_rng(seed), seconds, 16000)
    a = (0.5 * a / (np.abs(a).max() + 1e-9)).astype(np.float32)
    return [a[i: i + 1600] for i in range(0, len(a), 1600)]


def test_entry_point_serves_the_tiny_checkpoint_on_cpu(tiny_ckpt, monkeypatch):
    """``build_server`` (what ``python -m thewhisper_tpu_torch.server``
    runs) on "cpu", from the environment: the pipeline it builds (reuse
    on), the warm-up called before the transcriber exists, /health saying
    "cpu", and a session served through the engine."""
    from thewhisper_tpu_torch.pipeline import ASRPipeline
    from thewhisper_tpu_torch.server import launch

    for k, v in {"ASR_MODEL": tiny_ckpt, "ASR_MODEL_SIZE": "XL32",
                 "ASR_WARMUP": "1"}.items():
        monkeypatch.setenv(k, v)
    for k in ("ASR_BACKEND_TYPE", "ASR_LATENCY_BUCKETS", "ASR_REUSE_PREV",
              "ASR_DRAFT"):
        monkeypatch.delenv(k, raising=False)
    events = []
    monkeypatch.setattr(launch, "warm_up", lambda asr, chunk_s, max_new, nb: (
        events.append(("warm_up", chunk_s, max_new, nb))))
    real_bt = launch.BatchedTranscriber
    monkeypatch.setattr(launch, "BatchedTranscriber", lambda *a, **k: (
        events.append(("transcriber", k)) or real_bt(*a, **k)))
    sizes = []
    real = ASRPipeline.transcribe_batch

    def recording(self, audios, *args, **kwargs):
        sizes.append(len(audios))
        return real(self, audios, *args, **kwargs)

    monkeypatch.setattr(ASRPipeline, "transcribe_batch", recording)
    server, transcriber = launch.build_server(
        device="cpu", config=ServerConfig(host="127.0.0.1", port=0))
    assert events == [("warm_up", 10, 128, 8), ("transcriber", {
        "max_batch": 8, "max_new_tokens": 128})]
    asr = transcriber.pipeline
    assert asr._reuse_previous and asr.engine.device.type == "cpu"
    assert asr.engine.compute_dtype == torch.float32
    server.start_background()
    try:
        c = Client(server.port)
        assert c("GET", "/health")[1]["backend"] == "cpu"
        c.close()
        ticks = _drive(server.port, _speech(3.0, seed=1))
    finally:
        server.shutdown()
        transcriber.close()
    assert len(ticks) == 30 and sizes and set(sizes) == {1}


def test_warm_up_runs_every_batch_size_of_a_full_window():
    """Every batch size 1 to ``max_batch`` is warmed through the bucket it
    pads to (``engine.warmup`` at the pipeline's window, word timestamps),
    then one full rolling window runs the rest of the path."""
    from types import SimpleNamespace

    from thewhisper_tpu_torch.server.launch import warm_up

    for max_batch, buckets in ((3, [1, 2, 4]), (8, [1, 2, 4, 8])):
        pipe = FakePipeline()
        calls, warmed = [], []
        pipe.transcribe_batch = lambda audios, **kw: calls.append(
            ([len(a) for a in audios], kw))
        pipe.featurizer = SimpleNamespace(num_mel_frames=lambda: 1000)
        pipe.latency_buckets = [10.0]
        pipe._featurizer_for = lambda s, _f=pipe.featurizer: _f
        pipe.engine = SimpleNamespace(
            batch_buckets=(1, 2, 4, 8, 16, 32, 64),
            warmup=lambda *a, **kw: warmed.append((a, kw)))
        warm_up(pipe, 10, max_new_tokens=64, max_batch=max_batch)
        assert warmed == [((1000,), {"batches": buckets, "max_new_tokens": 64,
                                     "timestamps": True})]
        assert calls == [([9 * 16000], {
            "return_timestamps": "word",
            "generate_kwargs": {"max_new_tokens": 64, "language": "en"}})]


def test_warm_up_makes_each_bucket_program_on_the_tiny_checkpoint(tiny_ckpt):
    """On the CPU the warm-up makes one decode program a bucket (the keys
    of JAX's compile cache) and no request of those shapes makes another."""
    from thewhisper_tpu_torch.pipeline import ASRPipeline
    from thewhisper_tpu_torch.server.launch import warm_up

    asr = ASRPipeline(tiny_ckpt, chunk_length_s=10, device="cpu",
                      compute_dtype=torch.float32)
    warm_up(asr, 10, max_new_tokens=3, max_batch=3)
    keys = [p["key"] for p in asr.engine.programs()]
    frames = asr.featurizer.num_mel_frames()
    assert sorted(keys) == [(b, frames, 4, 3, True, 1) for b in (1, 2, 4)]
    assert not any(p["graph"] for p in asr.engine.programs())
    asr.transcribe_batch([np.zeros(16000, np.float32)] * 3,
                         generate_kwargs={"max_new_tokens": 3, "language": "en"})
    assert len(asr.engine.programs()) == 3


def test_serve_pipeline_keeps_every_warmed_program(tiny_ckpt):
    """Latency buckets 2.5 and 5 s beside the 10 s chunk, at ``max_batch``
    8: the warm-up makes 3 x 4 programs, more than ``MAX_PROGRAMS``, and the
    engine keeps every one of them, also after requests of other shapes."""
    from thewhisper_tpu_torch.engine.engine import MAX_PROGRAMS
    from thewhisper_tpu_torch.pipeline import ASRPipeline
    from thewhisper_tpu_torch.server.launch import serve_pipeline

    asr = ASRPipeline(tiny_ckpt, chunk_length_s=10, device="cpu",
                      compute_dtype=torch.float32, latency_buckets=[2.5, 5])
    server, transcriber = serve_pipeline(
        asr, ServerConfig(host="127.0.0.1", port=0), max_batch=8,
        max_new_tokens=3)
    server.start_background()
    server.shutdown()
    transcriber.close()
    warmed = {(b, frames, 4, 3, True, 1) for b in (1, 2, 4, 8)
              for frames in (250, 500, 1000)}
    assert len(warmed) > MAX_PROGRAMS
    assert warmed <= {p["key"] for p in asr.engine.programs()}
    for n in range(1, MAX_PROGRAMS + 2):        # another shape each
        asr.transcribe_batch([np.zeros(16000, np.float32)],
                             generate_kwargs={"max_new_tokens": 3 + n,
                                              "language": "en"})
    keys = {p["key"] for p in asr.engine.programs()}
    assert warmed <= keys and len(keys - warmed) == MAX_PROGRAMS


def test_served_sessions_on_the_tiny_checkpoint(tiny_ckpt):
    """The server's objects over the tiny f32 checkpoint: three sessions at
    once coalesce into a batch above 1, and a lone session's words equal a
    StreamingPipeline's fed the same chunks directly over a fresh
    transcriber. Three tokens a tick, so that the random model's repeats
    stay under the gibberish gate and the words are not all empty."""
    from thewhisper_tpu_torch.pipeline import ASRPipeline
    from thewhisper_tpu_torch.server.launch import serve_pipeline
    from thewhisper_tpu_torch.streaming import StreamingPipeline

    asr = ASRPipeline(tiny_ckpt, chunk_length_s=10, device="cpu",
                      compute_dtype=torch.float32, reuse_previous_tokens=True)
    sizes = []
    real = asr.transcribe_batch
    asr.transcribe_batch = lambda audios, **kw: sizes.append(
        len(audios)) or real(audios, **kw)
    server, transcriber = serve_pipeline(
        asr, ServerConfig(host="127.0.0.1", port=0), warmup=False,
        max_batch=4, max_new_tokens=3)
    streams = [_speech(3.0, seed=s) for s in (1, 2, 3)]
    server.start_background()
    try:
        barrier = threading.Barrier(3)
        results, errors = [], []

        def worker(chunks):
            try:
                results.append(_drive(server.port, chunks, barrier))
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(s,)) for s in streams]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors and len(results) == 3
        assert max(sizes) > 1
        asr._prev_gen_tokens = None
        served = _drive(server.port, streams[0])
    finally:
        server.shutdown()
        transcriber.close()
    direct_bt = BatchedTranscriber(
        ASRPipeline(asr.engine, tokenizer=asr.tokenizer, chunk_length_s=10,
                    reuse_previous_tokens=True), max_new_tokens=3)
    try:
        sp = StreamingPipeline(backend=direct_bt.backend(), chunk_length_s=10)
        direct = [sp(c) for c in streams[0]]
    finally:
        direct_bt.close()
    assert json.loads(json.dumps(direct)) == served
    assert any(c or a for c, a in served)


def test_entry_point_refuses_what_is_not_ported(monkeypatch):
    """``ASR_LATENCY_BUCKETS`` reaches the pipeline as JAX's example passes
    it; a value that is not seconds, or no ``ASR_MODEL``, stops the entry
    point; the remote backend needs neither."""
    from thewhisper_tpu_torch import pipeline
    from thewhisper_tpu_torch.server import launch

    monkeypatch.delenv("ASR_BACKEND_TYPE", raising=False)
    monkeypatch.delenv("ASR_WARMUP", raising=False)
    made = []
    monkeypatch.setattr(pipeline, "ASRPipeline", lambda model, **kw: (
        made.append((model, kw)) or "asr"))
    monkeypatch.setattr(launch, "serve_pipeline", lambda asr, config, warmup: (
        asr, warmup))
    monkeypatch.setenv("ASR_MODEL", "/nonexistent/checkpoint")
    monkeypatch.setenv("ASR_LATENCY_BUCKETS", "2.5,5")
    assert launch.build_server(device="cpu") == ("asr", True)
    assert made[0][0] == "/nonexistent/checkpoint"
    assert made[0][1]["latency_buckets"] == [2.5, 5.0]
    monkeypatch.setenv("ASR_LATENCY_BUCKETS", "2.5,five")
    with pytest.raises(SystemExit, match="ASR_LATENCY_BUCKETS"):
        launch.build_server(device="cpu")
    monkeypatch.delenv("ASR_LATENCY_BUCKETS")
    monkeypatch.delenv("ASR_MODEL", raising=False)
    with pytest.raises(SystemExit):
        launch.build_server(device="cpu")
    monkeypatch.setenv("ASR_BACKEND_TYPE", "whisper")
    monkeypatch.setenv("TRITON_URL", "http://127.0.0.1:9/unused")
    server, transcriber = launch.build_server(
        device="cpu", config=ServerConfig(host="127.0.0.1", port=0))
    server.start_background()
    try:
        assert transcriber is None
        assert server.manager.backend_type == "whisper"
        backend = server.manager.backend_factory()
        assert backend.api_url == "http://127.0.0.1:9/unused"
    finally:
        server.shutdown()
