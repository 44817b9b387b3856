"""The multi-rank dry run: the serving parts of the JAX package's
``__graft_entry__.dryrun_multichip`` on ``n`` ranks of a ``(dp, tp)``
mesh.

:func:`dryrun_multichip` spawns the ranks (``parallel.launch.spawn``) once
for each mesh of the sweep (dp * tp = n; tp of 1, 2 and 4 where they
divide n and the heads) at the JAX dry run's tiny flagship-shaped arch
(large-v3-turbo's structure, d_model 128, 2 + 2 layers, 4 heads, d_ff 256,
vocab 512, a 1 s chunk). Every rank runs :func:`mesh_checks`; rank 0
serves the same calls on an unsharded engine over the same weights and on
the meshed one, and the run asserts they agree:

- the full bucketed generate (suppress masks, timestamps, alignment
  capture) at batch 8: tokens and ``num_generated`` equal, ``sum_logprob``
  and the alignment within 1e-4 and 1e-3;
- beam search (2 beams), a sampled call, language detection;
- the offset-window path (four windows of one file on the device);
- the batching coalescer, one language per request, its text equal;
- every tp rank's result rows equal to its group's, bit for bit.

The child functions live in this module because a spawned child imports
its function by module path (a test module is not importable there).
``tests/test_torch_parallel.py`` runs :func:`mesh_checks` with JAX's
weights and holds the meshed results against JAX's one-device engine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from thewhisper_tpu_torch.config import (
    ARCH_PRESETS,
    LANGUAGES,
    GenerationOptions,
    SpecialTokens,
)

# The JAX dry run's arch and special tokens; a second alignment head, on
# the last tp rank at tp 2 and 4, so that the capture sums across ranks.
TINY_ARCH = dataclasses.replace(
    ARCH_PRESETS["large-v3-turbo"],
    d_model=128, encoder_layers=2, encoder_heads=4, decoder_layers=2,
    decoder_heads=4, d_ff=256, vocab_size=512, n_mels=128,
    max_source_positions=50, max_target_positions=32,
    alignment_heads=((1, 0), (1, 3)),
)
TINY_SPECIAL = SpecialTokens(
    eot=1, sot=2, first_language=10, n_languages=5, translate=20,
    transcribe=21, no_speech=22, no_timestamps=23, timestamp_begin=24)
SUPPRESS, BEGIN_SUPPRESS = (5, 6), (7,)
BATCH = 8
GENERATE = GenerationOptions(max_new_tokens=6, language="en",
                             return_timestamps=True)
WINDOWS = GenerationOptions(max_new_tokens=4, language="en")
BEAM = dataclasses.replace(GENERATE, num_beams=2)
SAMPLED = GenerationOptions(max_new_tokens=6, language="en",
                            temperature=0.7, seed=1)
COALESCED_TOKENS = 6
# Random models draw their biases and LayerNorm parameters from N(0, 0.1)
# (scales 1 + N): with JAX's zero biases, a bias added on every tp rank
# instead of once would go unseen.
BIAS_STD = 0.1


def make_inputs(arch=TINY_ARCH, batch: int = BATCH, n_requests: int = 3,
                seed: int = 11) -> Dict[str, Any]:
    """The dry run's inputs, as numpy, from ``seed``: features for the
    generate, a file of four model chunks with four window offsets (JAX's
    dry run's), and ``n_requests`` one-second buffers with a language
    each for the coalescer."""
    rng = np.random.default_rng(seed)
    sr = 16000
    bucket = int(arch.max_source_positions / 50.0 * sr)
    win = int(0.8 * bucket)
    langs = [LANGUAGES[i % TINY_SPECIAL.n_languages] for i in range(n_requests)]
    return {
        "mel": rng.standard_normal((batch, arch.n_mels, 100), dtype=np.float32),
        "file": (0.1 * rng.standard_normal(4 * bucket)).astype(np.float32),
        "offsets": [0, win // 2, win, 2 * win], "win": win, "bucket": bucket,
        "requests": [(0.1 * rng.standard_normal(sr)).astype(np.float32)
                     for _ in range(n_requests)],
        "languages": langs,
    }


def _fields(res) -> Dict[str, Any]:
    return {"tokens": res.tokens, "num_generated": res.num_generated,
            "sum_logprob": res.sum_logprob, "align": res.align,
            "decode_steps": res.decode_steps}


def serve(engine, inputs: Dict[str, Any], arch=TINY_ARCH) -> Dict[str, Any]:
    """The dry run's calls on ``engine`` (rank 0's, meshed or not), in one
    order: a warm-up of the generate's key, generate, beam, sampled,
    language detection, the offset windows, the coalescer. Returns their
    results as numpy."""
    from thewhisper_tpu_torch.pipeline import ASRPipeline
    from thewhisper_tpu_torch.streaming.batching import BatchedTranscriber

    mel = inputs["mel"]
    engine.warmup(mel.shape[-1], batches=(BATCH,),
                  max_new_tokens=GENERATE.max_new_tokens)
    out = {"generate": _fields(engine.transcribe_features(mel, GENERATE)),
           "beam": _fields(engine.transcribe_features(mel, BEAM)),
           "sampled": _fields(engine.transcribe_features(mel, SAMPLED))}
    out["languages"] = engine.detect_language(mel)[0].tolist()
    out["windows"] = _fields(engine.transcribe_windows_async(
        inputs["file"], inputs["offsets"], inputs["win"], inputs["bucket"],
        WINDOWS).result())
    pipe = ASRPipeline(engine, tokenizer=None,
                       chunk_length_s=arch.max_source_positions / 50)
    bt = BatchedTranscriber(pipe, max_new_tokens=COALESCED_TOKENS,
                            max_batch=BATCH, max_wait_ms=50.0)
    try:
        futs = [bt.submit(a, language=lang) for a, lang in
                zip(inputs["requests"], inputs["languages"])]
        out["coalescer"] = [f.result(timeout=300)["text"] for f in futs]
    finally:
        bt.close()
    return out


def mesh_checks(dp: int, tp: int,
                weights: Optional[Dict[str, np.ndarray]] = None,
                seed: int = 3, device="cpu", reference: bool = True
                ) -> Dict[str, Any]:
    """One rank of the dry run's mesh (``parallel.launch.spawn`` runs it on
    dp * tp ranks). ``weights``: the full model's state dict as numpy (the
    port's names; e.g. JAX's tree through ``params_from_jax``), else the
    port's ``init_params`` from ``seed`` (``BIAS_STD``). Every rank shards
    the model and encodes its dp rows of the inputs' features directly
    (``encoder``, the tp collectives on every rank); then rank 0 serves
    (:func:`serve`) on the meshed engine while the others ``follow`` it.
    With ``reference``, rank 0 first serves the same calls on an unsharded
    engine (``one_device``). Every rank returns the rows of each result it
    held before the gather (``local_rows``), and rank 0 the refusals of
    what a mesh does not run (``refusals``)."""
    from thewhisper_tpu_torch.engine.engine import WhisperEngine
    from thewhisper_tpu_torch.models.whisper import (
        encoder_forward,
        init_params,
        model_from_state,
    )
    from thewhisper_tpu_torch.parallel.follow import follow
    from thewhisper_tpu_torch.parallel.mesh import (
        batch_rows,
        make_mesh,
        shard_params,
    )

    arch = TINY_ARCH
    mesh = make_mesh(dp=dp, tp=tp, arch=arch, device=device)
    device = mesh.device
    inputs = make_inputs(arch)

    def model():
        if weights is not None:
            return model_from_state(weights, arch, device=device)
        return init_params(arch, torch.Generator(device).manual_seed(seed),
                           device=device, bias_std=BIAS_STD)

    def engine(m, mesh=None):
        return WhisperEngine(m, special=TINY_SPECIAL, suppress_tokens=SUPPRESS,
                             begin_suppress_tokens=BEGIN_SUPPRESS,
                             batch_buckets=(BATCH,), mesh=mesh)

    out: Dict[str, Any] = {"rank": mesh.rank, "dp_rank": mesh.dp_rank,
                           "tp_rank": mesh.tp_rank}
    if reference and mesh.rank == 0:
        out["one_device"] = serve(engine(model()), inputs, arch)
    sharded = shard_params(model(), mesh)
    out["local_heads"] = sharded.encoder.layers[0].attn.n_heads
    rows = batch_rows(mesh, BATCH)
    with torch.inference_mode():
        out["encoder"] = encoder_forward(sharded, torch.from_numpy(
            inputs["mel"][rows]).to(device)).cpu().numpy()
    eng = engine(sharded, mesh)
    seen = out["local_rows"] = []
    gather = eng._mirror.gather_rows

    def spy(rows_, steps, bucket):
        seen.append([r.copy() for r in rows_])
        return gather(rows_, steps, bucket)

    eng._mirror.gather_rows = spy
    if mesh.rank == 0:
        try:
            out["mesh"] = serve(eng, inputs, arch)
            out["refusals"] = _refusals(eng, sharded, mesh, inputs)
        finally:
            eng.close()
    else:
        follow(eng)
    return out


def _refusals(eng, sharded, mesh, inputs) -> Dict[str, str]:
    """What a meshed engine refuses, each refusal's message (each raises
    before any collective, so rank 0 alone may try them)."""
    from thewhisper_tpu_torch.engine.engine import WhisperEngine

    tries = {
        "spec_ngram": lambda: WhisperEngine(sharded, spec_ngram=True,
                                            mesh=mesh),
        "cross_kv_int8": lambda: WhisperEngine(sharded, cross_kv_int8=True,
                                               mesh=mesh),
        "proposals": lambda: eng.transcribe_features(
            inputs["mel"], GENERATE, draft_tokens=np.zeros((BATCH, 2))),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)
    return out


def check_against_one_device(results) -> None:
    """Assert the meshed results of one spawn (every rank's
    :func:`mesh_checks`) against rank 0's one-device ones and the tp
    ranks' tokens against each other's."""
    lead = results[0]
    ref, got = lead["one_device"], lead["mesh"]
    for name in ("generate", "beam", "sampled", "windows"):
        a, b = ref[name], got[name]
        np.testing.assert_array_equal(a["tokens"], b["tokens"], err_msg=name)
        np.testing.assert_array_equal(a["num_generated"], b["num_generated"],
                                      err_msg=name)
        np.testing.assert_allclose(a["sum_logprob"], b["sum_logprob"],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        if a["align"] is not None:
            np.testing.assert_allclose(a["align"], b["align"], rtol=1e-3,
                                       atol=1e-3, err_msg=name)
        assert a["decode_steps"] == b["decode_steps"], name
    assert ref["languages"] == got["languages"]
    assert ref["coalescer"] == got["coalescer"], (ref["coalescer"],
                                                  got["coalescer"])
    assert sorted(lead["refusals"]) == ["cross_kv_int8", "proposals",
                                        "spec_ngram"], lead["refusals"]
    check_tp_ranks(results)


def check_tp_ranks(results) -> None:
    """Every rank's result rows before the gather (tokens, lengths,
    logprobs, alignment) equal, bit for bit, those of tp rank 0 of its dp
    group."""
    first = {r["dp_rank"]: r for r in results if r["tp_rank"] == 0}
    for r in results:
        mine, theirs = r["local_rows"], first[r["dp_rank"]]["local_rows"]
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def sweep(n_devices: int):
    """The meshes of the dry run over ``n_devices`` ranks: (n / tp, tp) for
    tp of 1, 2 and 4 where tp divides n and the tiny arch's heads."""
    return [(n_devices // tp, tp) for tp in (1, 2, 4)
            if n_devices % tp == 0 and TINY_ARCH.decoder_heads % tp == 0]


def dryrun_multichip(n_devices: int = 4, backend: str = "gloo",
                     device: str = "cpu") -> Dict[str, str]:
    """Spawn ``n_devices`` ranks for each mesh of :func:`sweep` and assert
    that each meshed engine serves what one device serves
    (:func:`check_against_one_device`). ``backend``/``device``: gloo on
    the CPU (or several ranks on one card), NCCL with a card a rank.
    Prints one line and returns {mesh: "PASS"}."""
    from thewhisper_tpu_torch.parallel.launch import spawn

    passed = {}
    t0 = time.perf_counter()
    for dp, tp in sweep(n_devices):
        results = spawn(mesh_checks, n_devices, dp, tp, None, 3, device,
                        backend=backend, device=device)
        check_against_one_device(results)
        passed[f"dp{dp}xtp{tp}"] = "PASS"
    print(f"dryrun_multichip OK: n={n_devices} backend={backend} "
          f"device={device} meshes="
          + ",".join(f"{m}:{r}" for m, r in passed.items())
          + f" seconds={time.perf_counter() - t0:.1f}")
    return passed


# ---------------------------------------------------------------------------
# On the card: the children of chip_smoke.py's [MESH] phase
# ---------------------------------------------------------------------------

CARD_ARCH = dataclasses.replace(
    ARCH_PRESETS["large-v3-turbo"],
    # A few heads on the last two decoder layers, so the capture has input.
    alignment_heads=((2, 4), (2, 11), (3, 3), (3, 17)))


def card_audio(rows: int, seconds: float, seed: int) -> np.ndarray:
    """(rows, seconds * 16000) f32 noise from ``seed``."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((rows, int(seconds * 16000)))
            ).astype(np.float32)


def _counts() -> Dict[str, int]:
    from thewhisper_tpu_torch.ops import attention, logmel
    from thewhisper_tpu_torch.parallel import mesh

    return {"K1": logmel.LOGMEL_LAUNCHES, "K2": attention.ATTN_LAUNCHES,
            "all_reduces": mesh.ALL_REDUCES,
            "captured_all_reduces": mesh.CAPTURED_ALL_REDUCES}


def _zero_counts() -> None:
    from thewhisper_tpu_torch.ops import attention, logmel
    from thewhisper_tpu_torch.parallel import mesh

    logmel.LOGMEL_LAUNCHES = attention.ATTN_LAUNCHES = 0
    mesh.ALL_REDUCES = mesh.CAPTURED_ALL_REDUCES = 0


def _timed(fn):
    """fn() and its wall, the card synchronized before and after."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _say(mesh, what: str) -> None:
    print(f"[MESH] rank {mesh.rank} (dp {mesh.dp_rank}, tp {mesh.tp_rank}) "
          f"{what}", flush=True)


def card_model(arch, dtype, seed: int, device):
    """A random model of ``arch`` from ``seed``, drawn on ``device``, with
    random biases (``BIAS_STD``)."""
    from thewhisper_tpu_torch.models.whisper import init_params

    return init_params(arch, torch.Generator(device).manual_seed(seed),
                       dtype=dtype, device=device, bias_std=BIAS_STD)


def _meshed_call(mesh, model, call):
    """Shard ``model`` over ``mesh``, build the meshed engine; rank 0 runs
    ``call(engine)`` (twice: the first makes the program, the second is
    timed) and closes the engine, the others follow it. Every rank
    returns (call's result or None, wall of the second call or None,
    K1/K2/all-reduce counts over both calls, its local head count)."""
    from thewhisper_tpu_torch.engine.engine import WhisperEngine
    from thewhisper_tpu_torch.parallel.follow import follow
    from thewhisper_tpu_torch.parallel.mesh import shard_params

    shard_params(model, mesh)
    eng = WhisperEngine(model, mesh=mesh)
    _zero_counts()
    res = wall = None
    if mesh.rank == 0:
        try:
            call(eng)
            res, wall = _timed(lambda: call(eng))
            res = (res, eng.cuda_graphs, [p["graph"] for p in eng.programs()])
        finally:
            eng.close()
    else:
        follow(eng)
    heads = model.encoder.layers[0].attn.n_heads
    counts = _counts()
    _say(mesh, f"K1 {counts['K1']} K2 {counts['K2']} launches, "
               f"{counts['all_reduces']} all-reduces "
               f"({counts['captured_all_reduces']} captured), "
               f"{heads} local heads of {model.arch.encoder_heads}")
    if mesh.device.type == "cuda" and (counts["K1"] <= 0 or counts["K2"] <= 0):
        raise RuntimeError(f"rank {mesh.rank}: K1/K2 not launched: {counts}")
    return res, wall, counts, heads


def card_nccl_graphs(seed: int = 0, max_new: int = 64, arch=CARD_ARCH,
                     seconds: float = 30.0) -> Dict[str, Any]:
    """(a) One rank over NCCL (dp 1 x tp 1): bf16 large-v3-turbo at full
    width from ``seed``, a 30 s input with word-timestamp alignment, through
    the unsharded engine and then the meshed one, both replaying CUDA
    graphs (the meshed loop's NCCL all-reduces inside its graph). Returns
    both results and walls; raises unless the tokens are bit-identical
    (on the CPU, a gloo rehearsal at a smaller ``arch``, without graphs)."""
    from thewhisper_tpu_torch.engine.engine import WhisperEngine
    from thewhisper_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=1, tp=1, arch=arch)
    dev = mesh.device
    audio = card_audio(1, seconds, seed + 1)
    opts = GenerationOptions(max_new_tokens=max_new, language="en",
                             return_timestamps=True)
    model = card_model(arch, torch.bfloat16, seed, dev)
    ref = WhisperEngine(model)
    ref.transcribe_audio(audio, opts)
    want, want_wall = _timed(lambda: ref.transcribe_audio(audio, opts))
    del ref
    (got, graphs, keys), wall, counts, heads = _meshed_call(
        mesh, model, lambda e: e.transcribe_audio(audio, opts))
    if dev.type == "cuda" and not (graphs and all(keys)):
        raise RuntimeError("the meshed NCCL engine did not replay a graph")
    if dev.type == "cuda" and counts["captured_all_reduces"] <= 0:
        raise RuntimeError("no all-reduce was captured into the graph")
    same = {k: bool(np.array_equal(getattr(want, k), getattr(got, k)))
            for k in ("tokens", "num_generated", "sum_logprob", "align")}
    if not (same["tokens"] and same["num_generated"]):
        raise RuntimeError(f"NCCL mesh of one differs from the unsharded "
                           f"engine: {same}")
    return {"same": same, "wall": wall, "unsharded_wall": want_wall,
            "counts": counts, "steps": got.decode_steps,
            "generated": got.num_generated.tolist()}


def check_gloo_collectives(device) -> None:
    """gloo's support on ``device`` for each collective a meshed engine
    runs there: all-reduce of f32 and bf16, broadcast of f32; raises
    ``RuntimeError`` naming the first that fails or sums wrong."""
    import torch.distributed as dist

    world = dist.get_world_size()
    for name, dtype in (("all_reduce", torch.float32),
                        ("all_reduce", torch.bfloat16),
                        ("broadcast", torch.float32)):
        x = torch.full((4, 8), float(dist.get_rank() + 1), dtype=dtype,
                       device=device)
        try:
            if name == "all_reduce":
                dist.all_reduce(x)
                want = world * (world + 1) / 2
            else:
                dist.broadcast(x, src=0)
                want = 1.0
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(
                f"gloo {name} of {dtype} on {device}: {e}") from e
        if not bool((x.float() == want).all()):
            raise RuntimeError(f"gloo {name} of {dtype} on {device} gave "
                               f"{x.flatten()[0].item()}, not {want}")


def _prefill_logits(model, audio: np.ndarray) -> torch.Tensor:
    """Last-position f32 logits of the "en transcribe" prompt on ``audio``:
    K1, the encoder, the cross K/V and the prefill (the tp all-reduces
    inside on a sharded model, so every rank of its group calls it)."""
    from thewhisper_tpu_torch.audio.features import (
        hann_window,
        log_mel_spectrogram,
        mel_filter_bank,
    )
    from thewhisper_tpu_torch.models.whisper import (
        compute_cross_kv,
        decoder_prefill,
        encoder_forward,
        make_cache,
    )

    arch, device = model.arch, model.device
    sp = SpecialTokens.for_vocab(arch.vocab_size)
    with torch.inference_mode():
        x = torch.from_numpy(audio).to(device)
        mel = log_mel_spectrogram(
            x, torch.from_numpy(mel_filter_bank(
                num_mel_filters=arch.n_mels)).to(device),
            torch.from_numpy(hann_window()).to(device))
        ck, cv = compute_cross_kv(model, encoder_forward(model, mel))
        cache = make_cache(arch, x.shape[0], 4, ck, cv)
        prompt = torch.tensor([[sp.sot, sp.language_id("en", LANGUAGES),
                                sp.transcribe, sp.no_timestamps]] * x.shape[0],
                              device=device)
        return decoder_prefill(model, prompt, cache)[0][:, -1].float()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def card_gloo_pair(seed: int = 0, max_new: int = 32, arch=CARD_ARCH,
                   seconds: float = 30.0) -> Dict[str, Any]:
    """(b) and (c): one of two gloo ranks that share the card. Checks
    gloo's collectives first. Then, at full large-v3-turbo width from
    ``seed``, TF32 off, on two 30 s rows: f32 at dp 1 x tp 2 and at
    dp 2 x tp 1, whose tokens and ``num_generated`` must equal the
    unsharded engine's (rank 0's, on the same weights); the dp-2
    coalescer with three requests, a language each, whose text must equal
    the unsharded pipeline's; bf16 at tp 2, whose prefill logits' relative
    L2 distance from the f32 unsharded model's must stay within 1.5x the
    bf16 unsharded model's (and whose agreeing token prefix is reported).
    Gloo meshes decode eagerly (no graph captures a gloo collective).
    Returns what rank 0 measured (walls, distances, prefixes) and every
    rank's counts and local heads. On the CPU it rehearses at a smaller
    ``arch`` and ``seconds``."""
    import torch.distributed as dist

    from thewhisper_tpu_torch.engine.engine import WhisperEngine
    from thewhisper_tpu_torch.parallel.mesh import local_device, make_mesh
    from thewhisper_tpu_torch.pipeline import ASRPipeline
    from thewhisper_tpu_torch.streaming.batching import BatchedTranscriber

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = local_device()
    lead = dist.get_rank() == 0
    check_gloo_collectives(dev)
    chunk = arch.max_source_positions / 50
    audio = card_audio(2, seconds, seed + 1)
    requests = list(card_audio(3, seconds / 3, seed + 2))
    langs = ["en", "de", "fr"]
    opts = GenerationOptions(max_new_tokens=max_new, language="en",
                             return_timestamps=True)
    out: Dict[str, Any] = {"rank": dist.get_rank(), "counts": {},
                           "heads": {}, "walls": {}}
    ref: Dict[str, Any] = {}
    if lead:
        model = card_model(arch, torch.float32, seed, dev)
        eng = WhisperEngine(model)
        eng.transcribe_audio(audio, opts)
        ref["f32"], out["walls"]["unsharded f32"] = _timed(
            lambda: eng.transcribe_audio(audio, opts))
        ref["text"] = [r["text"] for r in ASRPipeline(
            eng, chunk_length_s=chunk).transcribe_batch(
                requests, return_timestamps="word", languages=langs,
                generate_kwargs={"language": "en",
                                 "max_new_tokens": max_new, "num_beams": 1})]
        ref["logits32"] = _prefill_logits(model, audio)
        del eng, model

    def coalesce(eng):
        bt = BatchedTranscriber(ASRPipeline(eng, chunk_length_s=chunk),
                                language="en", max_new_tokens=max_new,
                                max_batch=4, max_wait_ms=2000.0)
        try:
            futs = [bt.submit(a, language=lang)
                    for a, lang in zip(requests, langs)]
            return [f.result(timeout=600)["text"] for f in futs]
        finally:
            bt.close()

    for dp, tp in ((1, 2), (2, 1)):
        name = f"dp{dp}xtp{tp} f32"
        mesh = make_mesh(dp=dp, tp=tp, arch=arch, device=dev)
        res, wall, out["counts"][name], out["heads"][name] = _meshed_call(
            mesh, card_model(arch, torch.float32, seed, dev),
            lambda e: e.transcribe_audio(audio, opts))
        if lead:
            got, graphs, _ = res
            out["walls"][name] = wall
            if graphs:
                raise RuntimeError("a gloo engine took CUDA graphs")
            for k in ("tokens", "num_generated"):
                if not np.array_equal(getattr(got, k), getattr(ref["f32"], k)):
                    raise RuntimeError(f"{name}: {k} differ from the unsharded "
                                       f"engine's")
            out[name] = {"generated": got.num_generated.tolist(),
                         "steps": got.decode_steps}
        if dp == 2:
            name = "dp2 coalescer"
            mesh = make_mesh(dp=2, tp=1, arch=arch, device=dev)
            res, wall, out["counts"][name], out["heads"][name] = _meshed_call(
                mesh, card_model(arch, torch.float32, seed, dev), coalesce)
            if lead:
                out["walls"][name] = wall
                out["text"] = res[0]
                if res[0] != ref["text"]:
                    raise RuntimeError(f"coalescer text {res[0]} != the "
                                       f"unsharded pipeline's {ref['text']}")

    model = card_model(arch, torch.bfloat16, seed, dev)
    if lead:
        eng = WhisperEngine(model)
        ref["bf16"] = eng.transcribe_audio(audio, opts)
        ref["logits16"] = _prefill_logits(model, audio)
        del eng
    mesh = make_mesh(dp=1, tp=2, arch=arch, device=dev)
    from thewhisper_tpu_torch.parallel.mesh import shard_params

    logits = _prefill_logits(shard_params(model, mesh), audio)
    del model
    name = "dp1xtp2 bf16"
    res, wall, out["counts"][name], out["heads"][name] = _meshed_call(
        mesh, card_model(arch, torch.bfloat16, seed, dev),
        lambda e: e.transcribe_audio(audio, opts))
    if lead:
        got = res[0]
        out["walls"][name] = wall
        base = _rel(ref["logits16"], ref["logits32"])
        mine = _rel(logits, ref["logits32"])
        out["bf16_logits"] = {"tp2_vs_f32": mine, "unsharded_vs_f32": base,
                              "tp2_vs_unsharded": _rel(logits, ref["logits16"])}
        if not mine <= 1.5 * base:
            raise RuntimeError(f"bf16 tp2 logits {mine} from f32, more than "
                               f"1.5x the unsharded bf16's {base}")
        a, b = got.tokens, ref["bf16"].tokens
        p = got.prompt_len
        agree = [int(np.argmax(np.append(a[i, p:] != b[i, p:], True)))
                 for i in range(a.shape[0])]
        out["bf16_prefix"] = {"agreeing": agree, "of": max_new,
                              "generated": got.num_generated.tolist()}
    return out
