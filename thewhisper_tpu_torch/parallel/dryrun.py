"""The multi-rank dry run: the JAX package's
``__graft_entry__.dryrun_multichip`` (serving, the sharded train step and
the sequence-parallel encoder) on ``n`` ranks of a ``(dp, tp)`` mesh.

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
- speculative calls on meshed engines (``speculate``): ngram drafting,
  the layer-skip draft of the sharded target and proposal tokens (rank
  0's, sent with the decode), tokens equal to the greedy call's and
  ``spec_rounds`` to the one-device engine's;
- every tp rank's result rows and loop counts equal to its group's, bit
  for bit, and every round's accepted counts too;

then, in a second spawn a mesh (:func:`train_dryrun`), the sharded train
step and the remat step (the loss finite and falling) and the
sequence-parallel encoder on the trained weights gathered back, against
the unsharded encoder on them.

The child functions live in this module because a spawned child imports
its function by module path (a test module is not importable there).
``tests/test_torch_parallel.py`` runs :func:`mesh_checks` with JAX's
weights and holds the meshed results against JAX's one-device engine;
``tests/test_torch_parallel_train.py`` runs :func:`train_checks` against
JAX's one-device training and encoder. The children of ``chip_smoke.py``
[MESH] and [MESH_TRAIN] are here too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

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
            "decode_steps": res.decode_steps, "spec_rounds": res.spec_rounds,
            "prompt_len": res.prompt_len}


# The speculative arms of the dry run, and those the CPU tests add (a
# whole draft on every rank, weight-only int8 drafts: whole, and the
# layer-skip draft's layers gathered whole). Drafts keep the first
# SPEC_DRAFT_LAYERS decoder layers.
SPEC_ARMS = ("ngram", "layer_skip", "proposals")
SPEC_TEST_ARMS = SPEC_ARMS + ("whole_draft", "draft_int8", "layer_skip_int8")
SPEC_DRAFT_LAYERS = 1


def proposals_from(tokens: np.ndarray, prompt_len: int,
                   vocab: int = TINY_ARCH.vocab_size) -> np.ndarray:
    """Proposal tokens (B, max_new) from a greedy call's ``tokens``: its
    generated tokens with every third one changed, so that rounds both
    accept and reject."""
    out = np.asarray(tokens)[:, prompt_len:].astype(np.int64)
    out[:, 2::3] = (out[:, 2::3] + 1) % vocab
    return out


def draft_state(weights: Dict[str, np.ndarray], n_layers: int
                ) -> Dict[str, np.ndarray]:
    """The decoder leaves of a layer-skip draft of ``n_layers`` layers (the
    port's names) from a whole model's state dict."""
    def keep(name: str) -> bool:
        parts = name.split(".")
        return parts[0] == "decoder" and (
            parts[1] != "layers" or int(parts[2]) < n_layers)
    return {k: v for k, v in weights.items() if keep(k)}


def draft_arch(arch, n_layers: int):
    """JAX's ``make_layer_skip_draft`` arch: the first ``n_layers``
    decoder layers and their alignment heads."""
    return dataclasses.replace(
        arch, decoder_layers=n_layers,
        alignment_heads=tuple((l, h) for l, h in arch.alignment_heads
                              if l < n_layers))


@contextlib.contextmanager
def accepted_per_round(log: list):
    """Append every speculative round's accepted counts (the loop's
    ``n_acc`` after the round, on the host) to ``log`` while inside: an
    eager loop's rounds only (a graph replay runs no Python)."""
    from thewhisper_tpu_torch.engine.speculative import SpecLoop

    step = SpecLoop._step

    def logged(self):
        step(self)
        log.append(self.n_acc.cpu().numpy().copy())

    SpecLoop._step = logged
    try:
        yield
    finally:
        SpecLoop._step = step


def spy_rows(engine, seen: list) -> None:
    """Record into ``seen`` the result rows and loop counts (steps, rounds;
    -1 for none) each call of the meshed ``engine`` held on this rank
    before the gather to rank 0."""
    gather = engine._mirror.gather_rows

    def spy(rows, counts, bucket):
        seen.append([r.copy() for r in rows]
                    + [np.asarray([-1 if c is None else c for c in counts])])
        return gather(rows, counts, bucket)

    engine._mirror.gather_rows = spy


def spec_kw(arm: str, model, whole_draft: Optional[Callable] = None,
            layers: int = SPEC_DRAFT_LAYERS) -> Dict[str, Any]:
    """The engine keywords of speculative ``arm`` over ``model`` (sharded
    or not): ngram drafting, the layer-skip draft of ``layers`` of
    ``model``'s own layers, a whole draft from ``whole_draft()`` (int8 or
    not), or no draft (proposals)."""
    from thewhisper_tpu_torch.engine.speculative import make_layer_skip_draft

    kw: Dict[str, Any] = {"draft_int8": arm.endswith("int8")}
    if arm == "ngram":
        kw["spec_ngram"] = True
    elif arm.startswith("layer_skip"):
        kw["draft_model"] = make_layer_skip_draft(model, layers)
    elif arm in ("whole_draft", "draft_int8"):
        kw["draft_model"] = whole_draft()
    return kw


def spec_call(engine, arm: str, mel: np.ndarray,
              proposals: Optional[np.ndarray]) -> Dict[str, Any]:
    """The speculative generate of ``arm`` on ``engine`` (``GENERATE``:
    suppress masks, timestamps, alignment), as numpy."""
    props = proposals if arm == "proposals" else None
    return _fields(engine.transcribe_features(mel, GENERATE,
                                              draft_tokens=props))


def speculate(mesh, sharded, make_engine: Callable, mel: np.ndarray,
              whole_draft: Callable, arms: Sequence[str] = SPEC_ARMS,
              proposals: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Every rank: for each speculative arm the meshed engine
    (:func:`spec_kw`) over the sharded model; rank 0 runs the arm's
    call (``proposals``: host data only rank 0 has) and closes the
    engine, the others follow it. Returns rank 0's results (``results``),
    and on every rank each arm's rows before the gather (``local_rows``)
    and accepted counts of every round (``accepted``)."""
    from thewhisper_tpu_torch.parallel.follow import follow

    out: Dict[str, Any] = {"results": {}, "local_rows": {}, "accepted": {}}
    for arm in arms:
        eng = make_engine(sharded, mesh, **spec_kw(arm, sharded, whole_draft))
        spy_rows(eng, out["local_rows"].setdefault(arm, []))
        with accepted_per_round(out["accepted"].setdefault(arm, [])):
            if mesh.rank == 0:
                try:
                    out["results"][arm] = spec_call(eng, arm, mel, proposals)
                finally:
                    eng.close()
            else:
                follow(eng)
    return out


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
                seed: int = 3, device="cpu", reference: bool = True,
                spec_arms: Sequence[str] = SPEC_ARMS,
                draft_weights: Optional[Dict[str, np.ndarray]] = None
                ) -> Dict[str, Any]:
    """One rank of the dry run's mesh (``parallel.launch.spawn`` runs it on
    dp * tp ranks). ``weights``: the full model's state dict as numpy (the
    port's names; e.g. JAX's tree through ``params_from_jax``), else the
    port's ``init_params`` from ``seed`` (``BIAS_STD``). Every rank shards
    the model and encodes its dp rows of the inputs' features directly
    (``encoder``, the tp collectives on every rank); then rank 0 serves
    (:func:`serve`) on the meshed engine while the others ``follow`` it,
    and every rank runs the speculative arms ``spec_arms``
    (:func:`speculate`; proposals from the meshed greedy call's tokens,
    whole drafts from ``draft_weights``, by default the layer-skip draft's
    leaves of ``weights``). With ``reference``, rank 0 first serves the
    same calls on unsharded engines (``one_device``, ``one_device_spec``).
    Every rank returns the rows and loop counts of each result it held
    before the gather (``local_rows``, ``spec_rows``) and the accepted
    counts of every speculative round (``accepted``), and rank 0 the
    refusals of what a mesh does not run (``refusals``)."""
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

    def whole_draft():
        state = draft_weights or draft_state(
            {k: v.cpu().numpy() for k, v in model().state_dict().items()},
            SPEC_DRAFT_LAYERS)
        return model_from_state(state, draft_arch(arch, SPEC_DRAFT_LAYERS),
                                device=device)

    def engine(m, mesh=None, **kw):
        return WhisperEngine(m, special=TINY_SPECIAL, suppress_tokens=SUPPRESS,
                             begin_suppress_tokens=BEGIN_SUPPRESS,
                             batch_buckets=(BATCH,), mesh=mesh, **kw)

    out: Dict[str, Any] = {"rank": mesh.rank, "dp_rank": mesh.dp_rank,
                           "tp_rank": mesh.tp_rank}
    if reference and mesh.rank == 0:
        out["one_device"] = ref = serve(engine(model()), inputs, arch)
        props = proposals_from(ref["generate"]["tokens"],
                               ref["generate"]["prompt_len"])
        out["one_device_spec"] = {}
        for arm in spec_arms:
            m = model()
            out["one_device_spec"][arm] = spec_call(
                engine(m, **spec_kw(arm, m, whole_draft)), arm, inputs["mel"],
                props)
    sharded = shard_params(model(), mesh)
    out["local_heads"] = sharded.encoder.layers[0].attn.n_heads
    rows = batch_rows(mesh, BATCH)
    with torch.inference_mode():
        out["encoder"] = encoder_forward(sharded, torch.from_numpy(
            inputs["mel"][rows]).to(device)).cpu().numpy()
    eng = engine(sharded, mesh)
    spy_rows(eng, out.setdefault("local_rows", []))
    props = None
    if mesh.rank == 0:
        try:
            out["mesh"] = serve(eng, inputs, arch)
            out["refusals"] = _refusals(engine, sharded, mesh, model,
                                        whole_draft)
        finally:
            eng.close()
        gen = out["mesh"]["generate"]
        props = proposals_from(gen["tokens"], gen["prompt_len"])
    else:
        follow(eng)
    spec = speculate(mesh, sharded, engine, inputs["mel"], whole_draft,
                     spec_arms, props)
    out["spec"] = spec["results"]
    out["spec_rows"], out["accepted"] = spec["local_rows"], spec["accepted"]
    return out


def _refusals(engine, sharded, mesh, model, whole_draft) -> Dict[str, str]:
    """What a meshed engine still refuses, each refusal's message (each
    raises before any collective, so rank 0 alone may try them): int8
    cross K/V, a quantized model, ngram drafting with a draft, a draft
    sharded for another tp, ``draft_int8`` on a draft sharded on its own."""
    from thewhisper_tpu_torch.engine.speculative import make_layer_skip_draft
    from thewhisper_tpu_torch.models.quant import quantize_params
    from thewhisper_tpu_torch.parallel.mesh import Mesh, shard_params

    other = Mesh(1, 2 if mesh.tp != 2 else 4)
    tries = {
        "cross_kv_int8": lambda: engine(sharded, mesh, cross_kv_int8=True),
        "quantized": lambda: engine(quantize_params(
            model(), components=("decoder",)), mesh),
        "ngram_and_draft": lambda: engine(
            sharded, mesh, spec_ngram=True,
            draft_model=make_layer_skip_draft(sharded, SPEC_DRAFT_LAYERS)),
        "draft_tp": lambda: engine(sharded, mesh, draft_model=shard_params(
            whole_draft(), other)),
        "draft_int8_sharded": lambda: engine(
            sharded, mesh, draft_int8=True,
            draft_model=shard_params(whole_draft(), mesh)),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)
    return out


REFUSALS = ("cross_kv_int8", "draft_int8_sharded", "draft_tp",
            "ngram_and_draft", "quantized")


def check_against_one_device(results) -> None:
    """Assert the meshed results of one spawn (every rank's
    :func:`mesh_checks`) against rank 0's one-device ones (speculative
    calls: tokens, lengths and rounds exact, and the tokens equal to the
    greedy call's) and the tp ranks' rows against each other's."""
    lead = results[0]
    ref, got = lead["one_device"], lead["mesh"]
    pairs = [(name, ref[name], got[name])
             for name in ("generate", "beam", "sampled", "windows")]
    pairs += [(f"spec {arm}", lead["one_device_spec"][arm], r)
              for arm, r in lead["spec"].items()]
    for name, a, b in pairs:
        np.testing.assert_array_equal(a["tokens"], b["tokens"], err_msg=name)
        np.testing.assert_array_equal(a["num_generated"], b["num_generated"],
                                      err_msg=name)
        np.testing.assert_allclose(a["sum_logprob"], b["sum_logprob"],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        if a["align"] is not None:
            np.testing.assert_allclose(a["align"], b["align"], rtol=1e-3,
                                       atol=1e-3, err_msg=name)
        assert a["decode_steps"] == b["decode_steps"], name
        assert a["spec_rounds"] == b["spec_rounds"], name
    for arm, r in lead["spec"].items():
        np.testing.assert_array_equal(r["tokens"], got["generate"]["tokens"],
                                      err_msg=arm)
        assert r["spec_rounds"] > 0, arm
    assert ref["languages"] == got["languages"]
    assert ref["coalescer"] == got["coalescer"], (ref["coalescer"],
                                                  got["coalescer"])
    assert tuple(sorted(lead["refusals"])) == REFUSALS, lead["refusals"]
    check_tp_ranks(results)


def check_tp_ranks(results) -> None:
    """Every rank's result rows before the gather (tokens, lengths,
    logprobs, alignment) and loop counts (steps, speculative rounds) equal,
    bit for bit, those of tp rank 0 of its dp group; so do the accepted
    counts of every speculative round."""
    first = {r["dp_rank"]: r for r in results if r["tp_rank"] == 0}

    def same(mine, theirs):
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)

    for r in results:
        lead = first[r["dp_rank"]]
        same(r["local_rows"], lead["local_rows"])
        for arm, rows in r.get("spec_rows", {}).items():
            same(rows, lead["spec_rows"][arm])
            same([r["accepted"][arm]], [lead["accepted"][arm]])


def sweep(n_devices: int):
    """The meshes of the dry run over ``n_devices`` ranks: (n / tp, tp) for
    tp of 1, 2 and 4 where tp divides n and the tiny arch's heads."""
    return [(n_devices // tp, tp) for tp in (1, 2, 4)
            if n_devices % tp == 0 and TINY_ARCH.decoder_heads % tp == 0]


def dryrun_multichip(n_devices: int = 4, backend: str = "gloo",
                     device: str = "cpu") -> Dict[str, str]:
    """Spawn ``n_devices`` ranks for each mesh of :func:`sweep` and assert
    that each meshed engine serves what one device serves
    (:func:`check_against_one_device`), then that each mesh trains
    (:func:`train_dryrun`, which raises on a loss that does not fall or a
    sequence-parallel encoder off the unsharded one). ``backend``/
    ``device``: gloo on the CPU (or several ranks on one card), NCCL with
    a card a rank. Prints one line and returns {mesh: "PASS"}."""
    from thewhisper_tpu_torch.parallel.launch import spawn

    passed = {}
    t0 = time.perf_counter()
    for dp, tp in sweep(n_devices):
        results = spawn(mesh_checks, n_devices, dp, tp, None, 3, device,
                        backend=backend, device=device)
        check_against_one_device(results)
        spawn(train_dryrun, n_devices, dp, tp, 3, device, backend=backend,
              device=device)
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


def _say(mesh, what: str, phase: str = "MESH") -> None:
    print(f"[{phase}] rank {mesh.rank} (dp {mesh.dp_rank}, tp {mesh.tp_rank}) "
          f"{what}", flush=True)


def card_model(arch, dtype, seed: int, device):
    """A random model of ``arch`` from ``seed``, drawn on ``device``, with
    random biases (``BIAS_STD``)."""
    from thewhisper_tpu_torch.models.whisper import init_params

    return init_params(arch, torch.Generator(device).manual_seed(seed),
                       dtype=dtype, device=device, bias_std=BIAS_STD)


def _meshed_call(mesh, model, call, engine_kw: Optional[Callable] = None,
                 repeat: bool = True, phase: str = "MESH"):
    """Shard ``model`` over ``mesh`` (unless it is sharded already), build
    the meshed engine (``engine_kw(model)``: more keywords); rank 0 runs
    ``call(engine)`` (with ``repeat`` twice: the first makes the program,
    the second is timed) and closes the engine, the others follow it.
    Every rank returns (call's result or None, wall of the timed call or
    None, K1/K2/all-reduce counts over the calls, its local head
    count)."""
    from thewhisper_tpu_torch.engine.engine import WhisperEngine
    from thewhisper_tpu_torch.parallel.follow import follow
    from thewhisper_tpu_torch.parallel.mesh import shard_params

    if model.tp is None:
        shard_params(model, mesh)
    eng = WhisperEngine(model, mesh=mesh,
                        **(engine_kw(model) if engine_kw else {}))
    _zero_counts()
    res = wall = None
    if mesh.rank == 0:
        try:
            if repeat:
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
               f"{heads} local heads of {model.arch.encoder_heads}", phase)
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
    or the sequence-parallel encoder's backward runs there: all-reduce of
    f32 and bf16, broadcast of f32, reduce-scatter of f32 and bf16 (the
    ``parallel.mesh`` call); raises ``RuntimeError`` naming the first that
    fails or sums wrong."""
    import torch.distributed as dist

    from thewhisper_tpu_torch.parallel.mesh import _reduce_scatter

    world = dist.get_world_size()
    for name, dtype in (("all_reduce", torch.float32),
                        ("all_reduce", torch.bfloat16),
                        ("broadcast", torch.float32),
                        ("reduce_scatter", torch.float32),
                        ("reduce_scatter", torch.bfloat16)):
        x = torch.full((4 * world, 8), float(dist.get_rank() + 1), dtype=dtype,
                       device=device)
        try:
            if name == "all_reduce":
                dist.all_reduce(x)
                want = world * (world + 1) / 2
            elif name == "reduce_scatter":
                x = _reduce_scatter(x, None, world)
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


# ---------------------------------------------------------------------------
# On the card: the children of chip_smoke.py's [MESH_SPEC] phase
# ---------------------------------------------------------------------------

# The card's speculative arms; a layer-skip draft of two decoder layers.
CARD_SPEC_ARMS = SPEC_ARMS
CARD_DRAFT_LAYERS = 2


def _card_spec_kw(arm: str) -> Callable:
    """``_meshed_call``'s engine keywords of speculative ``arm`` (a
    layer-skip draft of ``CARD_DRAFT_LAYERS``, made from the sharded
    model)."""
    return lambda model: spec_kw(arm, model, layers=CARD_DRAFT_LAYERS)


def _unsharded_spec(model, audio, opts, repeat: bool) -> Dict[str, Any]:
    """The unsharded engine's speculative calls on ``audio`` (each arm of
    ``CARD_SPEC_ARMS``; proposals from its greedy call's tokens): each
    result and the wall of its last call (with ``repeat`` the second, the
    first having made, and on the card captured, its program)."""
    from thewhisper_tpu_torch.engine.engine import WhisperEngine

    greedy = WhisperEngine(model).transcribe_audio(audio, opts)
    props = proposals_from(greedy.tokens, greedy.prompt_len,
                           model.arch.vocab_size)
    out: Dict[str, Any] = {"proposals": props, "results": {}, "walls": {}}
    for arm in CARD_SPEC_ARMS:
        eng = WhisperEngine(model, **_card_spec_kw(arm)(model))
        call = (lambda e=eng, a=arm: e.transcribe_audio(
            audio, opts, draft_tokens=props if a == "proposals" else None))
        if repeat:
            call()
        out["results"][arm], out["walls"][arm] = _timed(call)
        del eng
    return out


def _spec_same(want, got) -> Dict[str, bool]:
    return {k: bool(np.array_equal(getattr(want, k), getattr(got, k)))
            for k in ("tokens", "num_generated", "sum_logprob", "align")} | {
        "spec_rounds": want.spec_rounds == got.spec_rounds}


def card_spec_nccl(seed: int = 0, max_new: int = 64, arch=CARD_ARCH,
                   seconds: float = 30.0) -> Dict[str, Any]:
    """[MESH_SPEC] (a) One rank over NCCL (dp 1 x tp 1): bf16
    large-v3-turbo at full width from ``seed``, a 30 s input with
    alignment capture, ``max_new`` tokens: ngram drafting, the two-layer
    layer-skip draft and proposal tokens (the greedy call's, every third
    changed) through the unsharded engine, then the meshed one, both
    replaying CUDA graphs of their rounds (the meshed rounds' NCCL
    all-reduces inside). Raises unless every arm's tokens,
    ``num_generated`` and ``spec_rounds`` are bit-identical and, on the
    card, every meshed program replayed a graph with all-reduces in it.
    Returns each arm's comparison, rounds, walls and counts."""
    from thewhisper_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=1, tp=1, arch=arch)
    dev = mesh.device
    audio = card_audio(1, seconds, seed + 1)
    opts = GenerationOptions(max_new_tokens=max_new, language="en",
                             return_timestamps=True)
    model = card_model(arch, torch.bfloat16, seed, dev)
    _reset_peak(dev)
    ref = _unsharded_spec(model, audio, opts, repeat=True)
    out: Dict[str, Any] = {"arms": {}, "unsharded_peak_gib": _peak_gib(dev)}
    for arm in CARD_SPEC_ARMS:
        props = ref["proposals"] if arm == "proposals" else None
        _reset_peak(dev)
        (got, graphs, keys), wall, counts, heads = _meshed_call(
            mesh, model, lambda e: e.transcribe_audio(audio, opts,
                                                      draft_tokens=props),
            _card_spec_kw(arm), phase="MESH_SPEC")
        want = ref["results"][arm]
        if dev.type == "cuda" and not (graphs and all(keys)):
            raise RuntimeError(f"(a) {arm}: the meshed NCCL engine did not "
                               "replay a graph")
        if dev.type == "cuda" and counts["captured_all_reduces"] <= 0:
            raise RuntimeError(f"(a) {arm}: no all-reduce was captured")
        same = _spec_same(want, got)
        if not (same["tokens"] and same["num_generated"] and same["spec_rounds"]):
            raise RuntimeError(f"(a) {arm}: the NCCL mesh of one differs from "
                               f"the unsharded engine: {same}")
        out["arms"][arm] = {"same": same, "rounds": got.spec_rounds,
                            "generated": got.num_generated.tolist(),
                            "wall": wall, "unsharded_wall": ref["walls"][arm],
                            "peak_gib": _peak_gib(dev), "counts": counts,
                            "heads": heads}
    return out


def card_spec_gloo_pair(seed: int = 0, max_new: int = 32, arch=CARD_ARCH,
                        seconds: float = 30.0) -> Dict[str, Any]:
    """[MESH_SPEC] (b): one of two gloo ranks that share the card, f32
    with TF32 off, two 30 s rows, ``max_new`` tokens: every arm of
    ``CARD_SPEC_ARMS`` at dp 1 x tp 2 and at dp 2 x tp 1, its tokens,
    ``num_generated`` and ``spec_rounds`` equal to the unsharded engine's
    (rank 0's, on the same weights). Gloo meshes run their rounds eagerly;
    each round's accepted counts are logged on every rank for the parent
    to hold the tp ranks to each other. Returns rank 0's walls and every
    rank's counts, local heads and logs. On the CPU it rehearses at a
    smaller ``arch`` and ``seconds``."""
    import torch.distributed as dist

    from thewhisper_tpu_torch.parallel.mesh import local_device, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = local_device()
    lead = dist.get_rank() == 0
    check_gloo_collectives(dev)
    audio = card_audio(2, seconds, seed + 1)
    opts = GenerationOptions(max_new_tokens=max_new, language="en",
                             return_timestamps=True)
    out: Dict[str, Any] = {"rank": dist.get_rank(), "counts": {}, "heads": {},
                           "walls": {}, "accepted": {}, "arms": {},
                           "peaks": {}}
    ref: Dict[str, Any] = {}
    if lead:
        model = card_model(arch, torch.float32, seed, dev)
        ref = _unsharded_spec(model, audio, opts, repeat=False)
        out["walls"].update({f"unsharded {a} f32": w
                             for a, w in ref["walls"].items()})
        del model
    props = ref.get("proposals")
    for dp, tp in ((1, 2), (2, 1)):
        mesh = make_mesh(dp=dp, tp=tp, arch=arch, device=dev)
        model = card_model(arch, torch.float32, seed, dev)
        for arm in CARD_SPEC_ARMS:
            name = f"dp{dp}xtp{tp} {arm}"
            log = out["accepted"][name] = []
            _reset_peak(dev)
            with accepted_per_round(log):
                res, wall, out["counts"][name], out["heads"][name] = _meshed_call(
                    mesh, model, lambda e, a=arm: e.transcribe_audio(
                        audio, opts, draft_tokens=props if a == "proposals"
                        else None),
                    _card_spec_kw(arm), repeat=False, phase="MESH_SPEC")
            out["peaks"][name] = _peak_gib(dev)
            if lead:
                got, graphs, _ = res
                if graphs:
                    raise RuntimeError("a gloo engine took CUDA graphs")
                same = _spec_same(ref["results"][arm], got)
                if not (same["tokens"] and same["num_generated"]
                        and same["spec_rounds"]):
                    raise RuntimeError(f"(b) {name}: differs from the "
                                       f"unsharded engine: {same}")
                out["walls"][name] = wall
                out["arms"][name] = {"rounds": got.spec_rounds,
                                     "generated": got.num_generated.tolist()}
        del model
    return out


def check_spec_tp_ranks(pair) -> None:
    """[MESH_SPEC] (b): the two ranks' accepted counts of every round
    equal, bit for bit, in each tp-2 arm."""
    for name in pair[0]["accepted"]:
        if "tp2" not in name:
            continue
        a, b = (r["accepted"][name] for r in pair)
        if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"(b) {name}: the tp ranks accepted different "
                               "tokens")


# ---------------------------------------------------------------------------
# Training on the mesh and the sequence-parallel encoder
# ---------------------------------------------------------------------------

TRAIN_BATCH = 8
TRAIN_TOKENS = 16
PROMPT = 4
TRAIN_LR = 1e-3


def train_batch(arch=TINY_ARCH, batch: int = TRAIN_BATCH,
                tokens: int = TRAIN_TOKENS, seed: int = 0
                ) -> Dict[str, np.ndarray]:
    """A global training batch as numpy, from ``seed``: features (JAX's
    dry run's shape, 2 x max_source_positions frames), random token ids,
    and a loss mask that zeroes a ``PROMPT``-token prompt and pads each
    row to its own length (row i keeps 1 + (5 i mod (S - 5)) positions
    after the prompt), so that the dp ranks' mask counts differ."""
    rng = np.random.default_rng(seed)
    frames = 2 * arch.max_source_positions
    mask = np.zeros((batch, tokens), np.float32)
    for i in range(batch):
        mask[i, PROMPT: PROMPT + 1 + (5 * i) % (tokens - PROMPT - 1)] = 1.0
    return {"mel": rng.standard_normal((batch, arch.n_mels, frames),
                                       dtype=np.float32),
            "tokens": rng.integers(0, arch.vocab_size, (batch, tokens)
                                   ).astype(np.int64),
            "loss_mask": mask}


def _digest(t: torch.Tensor) -> str:
    """sha1 of a tensor's bytes (any type)."""
    import hashlib

    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha1(raw.numpy().tobytes()).hexdigest()


def _replicated_names(model):
    from thewhisper_tpu_torch.parallel.mesh import param_pspecs, placement

    specs = param_pspecs()
    return [n for n, _ in model.named_parameters()
            if not placement(n, specs).is_shard()]


def _digests(model, grads: bool, names=None) -> Dict[str, str]:
    """{name: sha1} of the parameters (or their gradients) named, default
    all."""
    params = dict(model.named_parameters())
    return {n: _digest(params[n].grad if grads else params[n])
            for n in (names or params)}


def gathered_grads(model) -> Dict[str, torch.Tensor]:
    """{name: whole gradient}: a sharded model's gradients gathered over
    its tp group (a collective), an unsharded model's as they are."""
    from thewhisper_tpu_torch.parallel.mesh import (
        gather_leaf,
        param_pspecs,
        placement,
    )

    specs = param_pspecs()
    return {n: (p.grad if model.tp is None else
                gather_leaf(p.grad, placement(n, specs), model.tp)).detach()
            for n, p in model.named_parameters()}


def _numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def _grad_step(model, batch, mesh, **kw):
    """loss_fn's forward and backward on a meshed (or unsharded) model,
    the gradients summed over dp: (global loss, whole gradients)."""
    from thewhisper_tpu_torch.parallel.mesh import reduce_gradients, sum_over_dp
    from thewhisper_tpu_torch.training.train import loss_fn

    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, mesh=mesh, **kw)
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        reduce_gradients(model.parameters(), mesh)
        loss = sum_over_dp(loss, mesh)
    return float(loss), gathered_grads(model)


def train_checks(dp: int, tp: int, weights: Dict[str, np.ndarray],
                 checks=("grads",), out_dir: Optional[str] = None,
                 device="cpu") -> Dict[str, Any]:
    """One rank of a meshed training run on ``weights`` (the port's state
    dict as numpy, ``TINY_ARCH``), the checks named in ``checks``:

    - ``grads``: the global loss and every gradient leaf (gathered) of
      :func:`train_batch` (seed 2), with and without remat (``remat``);
    - ``adam``: three AdamW steps (lr 1e-3, weight decay 0 and 0.01) on
      batches of seeds 10-12: each rank's digests of its parameters and
      gradients after every step, and the whole parameters after the last;
    - ``falls``: five steps on one batch, the losses;
    - ``bf16``: one step at a bf16 compute type over f32 weights;
    - ``seq``: the sequence-parallel encoder on whole weights (this rank's
      dp rows), gathered over tp, and its refusals;
    - ``save``: ``gather_params`` against the whole weights,
      ``save_hf_checkpoint`` and, after one step, ``save_train_state``
      into ``out_dir``, then a second step's loss and parameters.

    Returns this rank's results (whole tensors from every rank: the test
    compares the ranks)."""
    from thewhisper_tpu_torch.models.whisper import (
        encoder_forward,
        model_from_state,
    )
    from thewhisper_tpu_torch.ops import attention
    from thewhisper_tpu_torch.parallel import mesh as pm
    from thewhisper_tpu_torch.parallel.mesh import (
        gather_params,
        gather_seq,
        make_mesh,
        seq_rows,
        shard_params,
    )
    from thewhisper_tpu_torch.training.train import (
        init_train_state,
        make_train_step,
        place_batch,
    )

    arch = TINY_ARCH
    mesh = make_mesh(dp=dp, tp=tp, arch=arch, device=device)
    dev = mesh.device

    def model():
        return model_from_state(weights, arch, device=dev)

    def sharded(requires_grad: bool = True):
        return shard_params(model().requires_grad_(requires_grad), mesh)

    def batch(seed):
        return place_batch(train_batch(seed=seed), dev, mesh)

    out: Dict[str, Any] = {"rank": mesh.rank, "dp_rank": mesh.dp_rank,
                           "tp_rank": mesh.tp_rank}
    copies = attention.DOUT_COPIES
    if "grads" in checks:
        m = sharded()
        out["local_heads"] = m.encoder.layers[0].attn.n_heads
        for key, remat in (("grads", False), ("remat", True)):
            loss, grads = _grad_step(m, batch(2), mesh, remat=remat)
            out[key] = {"loss": loss, "grads": _numpy(grads),
                        "replicated": _digests(m, True, _replicated_names(m))}
    if "adam" in checks:
        for wd in (0.0, 0.01):
            state, tx = init_train_state(sharded(False), TRAIN_LR, wd)
            step = make_train_step(tx, mesh=mesh)
            steps = []
            for i in range(3):
                state, loss = step(state, batch(10 + i))
                steps.append({"loss": float(loss),
                              "params": _digests(state.params, False),
                              "grads": _digests(state.params, True)})
            out[f"adam{wd}"] = {"steps": steps, "params": _numpy(
                gather_params(state.params))}
    if "falls" in checks:
        state, tx = init_train_state(sharded(False), TRAIN_LR)
        step = make_train_step(tx, mesh=mesh)
        b = batch(1)
        losses = []
        for _ in range(5):
            state, loss = step(state, b)
            losses.append(float(loss))
        out["falls"] = {"losses": losses, "step": state.step}
    if "bf16" in checks:
        state, tx = init_train_state(sharded(False), TRAIN_LR)
        b = batch(5)
        loss32, _ = _grad_step(state.params, b, mesh)
        state, loss16 = make_train_step(tx, torch.bfloat16, mesh=mesh)(state, b)
        ps = list(state.params.parameters())
        out["bf16"] = {"loss32": loss32, "loss16": float(loss16),
                       "f32": all(p.dtype == torch.float32
                                  and p.grad.dtype == torch.float32 for p in ps),
                       "finite": all(bool(torch.isfinite(p.grad).all())
                                     for p in ps)}
    if "seq" in checks:
        whole = model()
        inputs = train_batch(seed=7)
        mel = place_batch({"mel": inputs["mel"]}, dev, mesh)["mel"]
        t = mel.shape[-1] // 2
        with torch.inference_mode():
            block = encoder_forward(whole, mel, seq=mesh)
            out["seq"] = {"rows": block.shape[1],
                          "expected_rows": seq_rows(mesh, t).stop
                          - seq_rows(mesh, t).start,
                          "out": gather_seq(mesh, block, t).cpu().numpy()}
        scatters = pm.REDUCE_SCATTERS
        out["seq"]["refusals"] = _seq_refusals(whole, sharded(False), mel, mesh)
        out["seq"]["autograd"] = {
            "reduce_scatters": pm.REDUCE_SCATTERS - scatters,
            "finite": all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                          for p in whole.encoder.parameters())}
    if "save" in checks:
        m = sharded(False)
        full = gather_params(m)
        ref = model().state_dict()
        out["gather_equal"] = sorted(full) == sorted(ref) and all(
            torch.equal(full[k], ref[k]) for k in ref)
        from thewhisper_tpu_torch.models.checkpoint import (
            save_hf_checkpoint,
            save_train_state,
        )

        save_hf_checkpoint(m, arch, f"{out_dir}/hf")
        state, tx = init_train_state(m, TRAIN_LR)
        step = make_train_step(tx, mesh=mesh)
        state, _ = step(state, batch(20))
        save_train_state(state, f"{out_dir}/state.pt")
        state, loss = step(state, batch(21))
        out["resume"] = {"loss": float(loss), "step": state.step,
                         "params": _numpy(gather_params(state.params))}
    out["dout_copies"] = attention.DOUT_COPIES - copies
    return out


def _seq_refusals(whole, sharded, mel, mesh) -> Dict[str, str]:
    """The sequence-parallel encoder's refusals (each raises before any
    collective): tp-sharded weights. Autograd, refused until SP's backward
    was ported, is tried too and must not raise (every rank runs it: its
    collectives are the mesh's)."""
    from thewhisper_tpu_torch.models.whisper import encoder_forward

    out = {}
    tries = {"sharded": lambda: encoder_forward(sharded, mel, seq=mesh),
             "autograd": lambda: encoder_forward(
                 whole.requires_grad_(True), mel, seq=mesh).sum().backward()}
    for name, fn in tries.items():
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)
    whole.requires_grad_(False)
    return out


SEQ_GRAD_ARMS = ("local", "gathered", "remat")


def seq_grad_checks(dp: int, tp: int, weights: Dict[str, np.ndarray],
                    mel: np.ndarray, cotangent: np.ndarray,
                    arms=SEQ_GRAD_ARMS, device="cpu") -> Dict[str, Any]:
    """One rank of the sequence-parallel encoder's backward on whole
    ``weights`` (``TINY_ARCH``): the gradient of ``(out * g).sum()`` for
    the global ``mel`` (B, n_mels, 2 T) and cotangent ``g`` (B, T, d),
    this rank holding its dp rows. Arms: ``local`` (the loss on this rank's
    block of rows, summed over the ranks by the gradients' sum),
    ``gathered`` (the loss on ``gather_seq``'s output, the same on every
    tp rank) and ``remat`` (``gathered`` with remat). After the backward
    every encoder leaf's gradient and the mel's are summed over tp
    (``sum_over_tp``) and the leaves' over dp (``reduce_gradients``).
    Returns, per arm, the leaves' gradients (whole, the port's names), this
    rank's dp rows of the mel's gradient, the leaves' gradient digests and
    the collectives the backward ran."""
    from thewhisper_tpu_torch.models.whisper import (
        encoder_forward,
        model_from_state,
    )
    from thewhisper_tpu_torch.parallel import mesh as pm

    arch = TINY_ARCH
    mesh = pm.make_mesh(dp=dp, tp=tp, arch=arch, device=device)
    dev = mesh.device
    rows = pm.batch_rows(mesh, mel.shape[0])
    x = torch.from_numpy(mel[rows]).to(dev)
    g = torch.from_numpy(cotangent[rows]).to(dev)
    t = x.shape[-1] // 2
    out: Dict[str, Any] = {"rank": mesh.rank, "dp_rank": mesh.dp_rank,
                           "tp_rank": mesh.tp_rank}
    for arm in arms:
        model = model_from_state(weights, arch, device=dev).requires_grad_(True)
        m = x.clone().requires_grad_(True)
        block = encoder_forward(model, m, seq=mesh, remat=arm == "remat")
        if arm == "local":
            loss = (block * g[:, pm.seq_rows(mesh, t)]).sum()
        else:
            loss = (pm.gather_seq(mesh, block, t) * g).sum()
        gathers, scatters = pm.ALL_GATHERS, pm.REDUCE_SCATTERS
        loss.backward()
        counts = {"all_gathers": pm.ALL_GATHERS - gathers,
                  "reduce_scatters": pm.REDUCE_SCATTERS - scatters}
        leaves = [(f"encoder.{n}", p) for n, p in model.encoder.named_parameters()]
        pm.sum_over_tp([p for _, p in leaves] + [m], mesh)
        pm.reduce_gradients([p for _, p in leaves], mesh)
        out[arm] = {"grads": {n: p.grad.cpu().numpy() for n, p in leaves},
                    "mel": m.grad.cpu().numpy(),
                    "digests": {n: _digest(p.grad) for n, p in leaves},
                    "counts": counts, "rows": block.shape[1]}
    return out


def train_dryrun(dp: int, tp: int, seed: int = 3, device="cpu"
                 ) -> Dict[str, Any]:
    """One rank of the dry run's training part (JAX's
    ``__graft_entry__.dryrun_multichip``: the sharded train step, the remat
    step, the sequence-parallel encoder) at ``TINY_ARCH`` from ``seed``:
    three sharded AdamW steps (lr 1e-3) on one batch of ``max(2 dp, dp)``
    rows, then three with remat, each run's loss finite and falling; then
    the trained weights gathered back (``gather_params``) through the
    sequence-parallel encoder, against the same weights' unsharded encoder
    (1e-5). Returns the losses and the largest difference."""
    from thewhisper_tpu_torch.models.whisper import (
        encoder_forward,
        model_from_state,
    )
    from thewhisper_tpu_torch.parallel.mesh import (
        gather_params,
        gather_seq,
        make_mesh,
        shard_params,
    )
    from thewhisper_tpu_torch.training.train import (
        init_train_state,
        make_train_step,
        place_batch,
    )

    arch = TINY_ARCH
    mesh = make_mesh(dp=dp, tp=tp, arch=arch, device=device)
    dev = mesh.device
    batch = place_batch(train_batch(batch=max(2 * dp, dp), seed=seed), dev,
                        mesh)
    model = shard_params(card_model(arch, torch.float32, seed, dev), mesh)
    out: Dict[str, Any] = {}
    for remat in (False, True):
        state, tx = init_train_state(model, TRAIN_LR)
        step = make_train_step(tx, remat=remat, mesh=mesh)
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(float(loss))
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise RuntimeError(f"remat={remat}: the loss did not fall: {losses}")
        out["remat" if remat else "step"] = losses
    whole = model_from_state(gather_params(model), arch, device=dev)
    with torch.inference_mode():
        t = batch["mel"].shape[-1] // 2
        sp = gather_seq(mesh, encoder_forward(whole, batch["mel"], seq=mesh), t)
        ref = encoder_forward(whole, batch["mel"])
    out["seq_err"] = float((sp - ref).abs().max())
    if not out["seq_err"] <= 1e-5:
        raise RuntimeError(f"sequence-parallel encoder off by {out['seq_err']}")
    return out


# ---------------------------------------------------------------------------
# On the card: the children of chip_smoke.py's [MESH_TRAIN] phase
# ---------------------------------------------------------------------------

# Full large-v3-turbo width, the encoder cut to 4 of its 32 layers (the
# decoder keeps its 4): a step's gradients are 1.0 GB in f32, which the
# parent writes once for the gloo ranks to read.
TRAIN_CARD_ARCH = dataclasses.replace(CARD_ARCH, encoder_layers=4)
CARD_TRAIN_SECONDS = 10.0
CARD_TRAIN_TOKENS = 64
CARD_SP_SECONDS = 30.0
CARD_SP_ROWS = 2
# Relative L2 distance of each gathered f32 gradient leaf of a gloo mesh
# from the unsharded step's (the same math, sums in another order).
CARD_GRAD_REL = 1e-4
# The sequence-parallel f32 encoder's relative L2 distance from the
# unsharded one's; bf16 ones are held to 1.5x the unsharded bf16
# distance from f32 ([MESH]'s rule for bf16 logits).
CARD_SP_REL = 1e-4
BF16_RATIO = 1.5
# (d), the sequence-parallel encoder's backward: the 30 s encoder cut to
# this many layers, a seeded cotangent, each gathered f32 gradient leaf
# within CARD_GRAD_REL of the unsharded encoder's.
CARD_SP_GRAD_LAYERS = 4


def sp_grad_path(path: str) -> str:
    """Where the parent writes (d)'s unsharded f32 gradients, beside (b)'s
    at ``path``."""
    return f"{path}.sp"


def _sp_grad_inputs(arch, seconds: float, seed: int, device):
    """(d)'s inputs: ``CARD_SP_ROWS`` rows of ``seconds`` through K1 and a
    seeded normal cotangent of the encoder's output shape."""
    from thewhisper_tpu_torch.audio.features import LogMelFeaturizer

    mel = LogMelFeaturizer(n_mels=arch.n_mels, chunk_length_s=seconds,
                           device=device)(card_audio(CARD_SP_ROWS, seconds,
                                                     seed + 9))
    g = torch.Generator(device=device).manual_seed(seed + 10)
    cot = torch.randn(CARD_SP_ROWS, mel.shape[-1] // 2, arch.d_model,
                      generator=g, device=device)
    return mel, cot


def _sp_grads(model, mel, cot, mesh=None, compute_dtype=None) -> Dict[str, torch.Tensor]:
    """{encoder leaf: gradient} of ``(out * cot).sum()`` through the
    encoder on ``mel`` (with ``mesh``, the sequence-parallel encoder: the
    loss on ``gather_seq``'s output, every leaf's gradient summed over tp
    and dp), cuDNN held to deterministic algorithms (the conv stem's
    gradient summed over tp must be the same bits on every rank)."""
    from thewhisper_tpu_torch.models.whisper import encoder_forward
    from thewhisper_tpu_torch.parallel import mesh as pm

    model.zero_grad(set_to_none=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = encoder_forward(model, mel, compute_dtype=compute_dtype, seq=mesh)
        if mesh is not None:
            out = pm.gather_seq(mesh, out, cot.shape[1])
        (out.float() * cot).sum().backward()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    leaves = [(f"encoder.{n}", p) for n, p in model.encoder.named_parameters()]
    if mesh is not None:
        pm.sum_over_tp([p for _, p in leaves], mesh)
        pm.reduce_gradients([p for _, p in leaves], mesh)
    return {n: p.grad.detach() for n, p in leaves}


def _flat(grads: Dict[str, torch.Tensor], names) -> torch.Tensor:
    return torch.cat([grads[n].reshape(-1).double().cpu() for n in names])


def card_train_batch(arch, rows: slice, n: int, seed: int, device,
                     seconds: float = CARD_TRAIN_SECONDS,
                     tokens: int = CARD_TRAIN_TOKENS) -> Dict[str, torch.Tensor]:
    """Rows ``rows`` of a global batch of ``n`` on ``device``: seeded noise
    of ``seconds`` through K1 (``LogMelFeaturizer``, only these rows),
    token rows of the English transcribe prompt and random text ids, and a
    loss mask that zeroes the ``PROMPT``-token prompt and pads row i after
    ``PROMPT + 20 + 9 i`` tokens (every row's count differs)."""
    from thewhisper_tpu_torch.audio.features import LogMelFeaturizer

    sp = SpecialTokens.for_vocab(arch.vocab_size)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, sp.eot, (n, tokens))
    ids[:, :PROMPT] = [sp.sot, sp.language_id("en", LANGUAGES[: sp.n_languages]),
                       sp.transcribe, sp.no_timestamps]
    mask = np.zeros((n, tokens), np.float32)
    for i in range(n):
        mask[i, PROMPT: min(tokens, PROMPT + 20 + 9 * i)] = 1.0
    featurizer = LogMelFeaturizer(n_mels=arch.n_mels, chunk_length_s=seconds,
                                  device=device)
    audio = card_audio(n, seconds, seed + 1)[rows]
    return {"mel": featurizer(audio),
            "tokens": torch.from_numpy(ids[rows]).to(device),
            "loss_mask": torch.from_numpy(mask[rows]).to(device)}


def _train_counts() -> Dict[str, int]:
    from thewhisper_tpu_torch.ops import attention, logmel

    return {"K1": logmel.LOGMEL_LAUNCHES, "K2": attention.ATTN_LAUNCHES,
            "K2-fwd-res": attention.ATTN_RES_LAUNCHES,
            "K2-dkv": attention.ATTN_BWD_DKV_LAUNCHES,
            "K2-dq": attention.ATTN_BWD_DQ_LAUNCHES,
            "dout_copies": attention.DOUT_COPIES}


def _zero_train_counts() -> None:
    from thewhisper_tpu_torch.ops import attention, logmel

    logmel.LOGMEL_LAUNCHES = attention.ATTN_LAUNCHES = 0
    attention.ATTN_RES_LAUNCHES = attention.ATTN_BWD_DKV_LAUNCHES = 0
    attention.ATTN_BWD_DQ_LAUNCHES = attention.DOUT_COPIES = 0


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device) -> Optional[float]:
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _fingerprint(tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Each tensor's sha1 and its f64 sum and sum of squares: equal bits,
    and where they differ, a measure of how far."""
    return {n: (_digest(t), float(t.double().sum()),
                float(t.double().square().sum())) for n, t in tensors.items()}


def _step_record(model) -> Dict[str, Any]:
    params = dict(model.named_parameters())
    return {"grads": _fingerprint({n: p.grad for n, p in params.items()}),
            "params": _fingerprint({n: p.detach() for n, p in params.items()})}


def _two_steps(model, batch, mesh):
    """(a)'s steps: two f32 AdamW steps (lr 1e-5) on ``batch``, the second
    with remat; each step's loss, gradients' and parameters'
    fingerprints, wall and peak memory. cuDNN is held to deterministic
    algorithms for them: its default weight-gradient algorithm for the
    conv stem's first layer sums in an order that changes from run to run
    (on an H100 two unsharded steps differ in ``encoder.conv1.weight``'s
    gradient alone), which a bit-for-bit comparison cannot take."""
    from thewhisper_tpu_torch.training.train import (
        init_train_state,
        make_train_step,
    )

    state, tx = init_train_state(model, 1e-5)
    out = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            _reset_peak(model.device)
            step = make_train_step(tx, remat=remat, mesh=mesh)
            (state, loss), wall = _timed(lambda: step(state, batch))
            out.append({"loss": float(loss), "wall": wall, "remat": remat,
                        "peak_gib": _peak_gib(model.device),
                        **_step_record(model)})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def mesh_train_reference(path: str, arch=TRAIN_CARD_ARCH, seed: int = 0,
                         sp_arch=CARD_ARCH, sp_seconds: float = CARD_SP_SECONDS,
                         seconds: float = CARD_TRAIN_SECONDS,
                         device=None) -> Dict[str, Any]:
    """The unsharded references of [MESH_TRAIN], computed in the parent on
    the card (TF32 off) before any child starts:

    (a) :func:`_two_steps` on a batch of 2 (its fingerprints);
    (b) one f32 step's loss and gradients on the global batch of 4 (the
        gradients written to ``path`` for the gloo ranks), and the same
        step at a bf16 compute type: its relative L2 distance from f32;
    (c) ``sp_arch``'s whole f32 and bf16 encoders on ``CARD_SP_ROWS``
        rows of ``sp_seconds`` through K1 (the outputs, and bf16's
        distance from f32);
    (d) ``sp_arch`` cut to ``CARD_SP_GRAD_LAYERS`` encoder layers, f32
        weights: the gradient of ``(out * g).sum()`` for a seeded
        cotangent, in f32 (written to ``sp_grad_path(path)``) and at a
        bf16 compute type (its relative L2 distance from f32).

    Returns them (and each arm's wall and peak memory)."""
    from thewhisper_tpu_torch.audio.features import LogMelFeaturizer
    from thewhisper_tpu_torch.models.whisper import encoder_forward
    from thewhisper_tpu_torch.parallel.mesh import local_device

    dev = local_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: Dict[str, Any] = {}
    out["a"] = _two_steps(card_model(arch, torch.float32, seed, dev),
                          card_train_batch(arch, slice(0, 2), 2, seed, dev,
                                           seconds), None)
    batch = card_train_batch(arch, slice(0, 4), 4, seed, dev, seconds)
    b = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = card_model(arch, torch.float32, seed, dev).requires_grad_(True)
        _reset_peak(dev)
        (loss, grads), wall = _timed(
            lambda: _grad_step(model, batch, None, compute_dtype=dtype))
        b[name] = {"loss": loss, "wall": wall, "peak_gib": _peak_gib(dev)}
        if name == "f32":
            torch.save({n: g.cpu() for n, g in grads.items()}, path)
            ref = grads
        else:
            b["bf16_vs_f32"] = _rel_l2(torch.cat([g.reshape(-1) for g in grads.values()]),
                                       torch.cat([ref[n].reshape(-1) for n in grads]))
        del model, grads
    out["b"] = b
    del ref
    mel = LogMelFeaturizer(n_mels=sp_arch.n_mels, chunk_length_s=sp_seconds,
                           device=dev)(card_audio(CARD_SP_ROWS, sp_seconds, seed + 7))
    c = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = card_model(sp_arch, dtype, seed, dev)
        _reset_peak(dev)
        with torch.inference_mode():
            enc, wall = _timed(lambda: encoder_forward(model, mel))
        c[name] = {"out": enc.float().cpu(), "wall": wall,
                   "peak_gib": _peak_gib(dev)}
        del model, enc
    c["bf16_vs_f32"] = _rel_l2(c["bf16"]["out"], c["f32"]["out"])
    out["c"] = c
    d_arch = dataclasses.replace(sp_arch, encoder_layers=min(
        sp_arch.encoder_layers, CARD_SP_GRAD_LAYERS))
    mel, cot = _sp_grad_inputs(d_arch, sp_seconds, seed, dev)
    d: Dict[str, Any] = {}
    model = card_model(d_arch, torch.float32, seed, dev).requires_grad_(True)
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        _reset_peak(dev)
        grads, wall = _timed(lambda: _sp_grads(model, mel, cot,
                                               compute_dtype=dtype))
        d[name] = {"wall": wall, "peak_gib": _peak_gib(dev)}
        if dtype is None:
            torch.save({n: g.cpu() for n, g in grads.items()}, sp_grad_path(path))
            d32 = grads
        else:
            d["bf16_vs_f32"] = _rel_l2(_flat(grads, grads), _flat(d32, grads))
    d["leaves"] = len(d32)
    out["d"] = d
    del model, mel, cot, grads, d32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def card_train_nccl(ref_a, arch=TRAIN_CARD_ARCH, seed: int = 0,
                    seconds: float = CARD_TRAIN_SECONDS) -> Dict[str, Any]:
    """(a) One rank over NCCL (dp 1 x tp 1): :func:`_two_steps` on the
    model sharded over the one-rank mesh (its *f*, *g*, dp reduce and
    loss count all run, each a collective of one rank), against the
    unsharded fingerprints ``ref_a``: the loss, every gradient leaf and
    every updated parameter, bit for bit (on the CPU, a gloo rehearsal).
    Returns the steps, which leaves differ and the launches."""
    from thewhisper_tpu_torch.parallel.mesh import make_mesh, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(dp=1, tp=1, arch=arch)
    dev = mesh.device
    batch = card_train_batch(arch, slice(0, 2), 2, seed, dev, seconds)
    model = shard_params(card_model(arch, torch.float32, seed, dev), mesh)
    _zero_train_counts()
    steps = _two_steps(model, batch, mesh)
    counts = _train_counts()
    differ = []
    for i, (got, want) in enumerate(zip(steps, ref_a)):
        if got["loss"] != want["loss"]:
            differ.append((i, "loss", got["loss"], want["loss"]))
        for kind in ("grads", "params"):
            for n, fp in got[kind].items():
                if fp[0] != want[kind][n][0]:
                    differ.append((i, f"{kind} {n}", fp[1:], want[kind][n][1:]))
    return {"steps": [{k: v for k, v in s.items() if k not in ("grads", "params")}
                      for s in steps],
            "leaves": len(steps[0]["grads"]), "differ": differ,
            "counts": counts, "heads": model.encoder.layers[0].attn.n_heads}


def _say_train(mesh, what: str) -> None:
    print(f"[MESH_TRAIN] rank {mesh.rank} (dp {mesh.dp_rank}, tp "
          f"{mesh.tp_rank}) {what}", flush=True)


def _meshed_step(mesh, arch, seed, n, ref, seconds: float,
                 compute_dtype=torch.float32, remat: bool = False
                 ) -> Dict[str, Any]:
    """One AdamW step (lr 1e-5) of a fresh f32 model sharded over
    ``mesh`` on this rank's rows of the global batch of ``n``: the global
    loss, the gathered gradients' relative L2 distance from ``ref`` (rank
    0; each leaf's worst, and all leaves together), the replicated leaves'
    and every parameter's digests after the step, the launches, local
    heads, wall and peak memory."""
    from thewhisper_tpu_torch.parallel.mesh import shard_params
    from thewhisper_tpu_torch.training.train import (
        init_train_state,
        local_rows,
        make_train_step,
    )

    dev = mesh.device
    batch = card_train_batch(arch, local_rows(n, mesh), n, seed, dev, seconds)
    model = shard_params(card_model(arch, torch.float32, seed, dev), mesh)
    state, tx = init_train_state(model, 1e-5)
    step = make_train_step(tx, compute_dtype, remat, mesh)
    _zero_train_counts()
    _reset_peak(dev)
    (state, loss), wall = _timed(lambda: step(state, batch))
    out = {"loss": float(loss), "wall": wall, "peak_gib": _peak_gib(dev),
           "counts": _train_counts(),
           "heads": model.encoder.layers[0].attn.n_heads,
           "f32_master": all(p.dtype == torch.float32 for p in model.parameters()),
           "replicated": _digests(model, True, _replicated_names(model)),
           "replicated_params": _digests(model, False, _replicated_names(model)),
           "params": _digests(model, False)}
    grads = gathered_grads(model)
    if mesh.rank == 0:
        grads = {n: g.cpu() for n, g in grads.items()}
        worst = max((_rel_l2(g, ref[n]), n) for n, g in grads.items())
        out["worst_leaf"] = worst
        out["all_leaves"] = _rel_l2(
            torch.cat([g.reshape(-1) for g in grads.values()]),
            torch.cat([ref[n].reshape(-1) for n in grads]))
    del grads, model, state, tx
    return out


def card_train_gloo_pair(ref_path: str, ref, arch=TRAIN_CARD_ARCH,
                         sp_arch=CARD_ARCH, seed: int = 0,
                         sp_seconds: float = CARD_SP_SECONDS,
                         seconds: float = CARD_TRAIN_SECONDS) -> Dict[str, Any]:
    """(b), (c) and (d): one of two gloo ranks that share the card, TF32
    off.

    (b) One f32 step each at dp 1 x tp 2 and dp 2 x tp 1 on the global
    batch of 4, then a remat step at tp 2, then a bf16-compute step at
    tp 2 over f32 master weights (:func:`_meshed_step`): the loss within
    1e-5 relative of the unsharded step's (``ref["b"]``), every gathered
    f32 gradient leaf within ``CARD_GRAD_REL`` of the unsharded
    gradients at ``ref_path``, bf16's distance from them within
    ``BF16_RATIO`` x the unsharded bf16 step's; K2-fwd-res, K2-dkv and
    K2-dq launched on every rank, none of its output gradients copied.

    (c) The sequence-parallel encoder at tp 2 on whole ``sp_arch``
    weights (30 s: 750 queries a rank over 1500 keys), f32 and bf16,
    against the unsharded encoders of ``ref["c"]``: f32 within
    ``CARD_SP_REL``, bf16 within ``BF16_RATIO`` x the unsharded bf16
    distance from f32.

    (d) The sequence-parallel encoder's backward at tp 2
    (:func:`_card_sp_grad`) against ``ref["d"]``.

    Raises on any miss; returns every rank's measurements (the parent
    checks the replicated leaves and (d)'s gradients across ranks). On
    the CPU it rehearses at smaller archs."""
    import torch.distributed as dist

    from thewhisper_tpu_torch.audio.features import LogMelFeaturizer
    from thewhisper_tpu_torch.models.whisper import encoder_forward
    from thewhisper_tpu_torch.parallel.mesh import (
        gather_seq,
        local_device,
        make_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = local_device()
    check_gloo_collectives(dev)
    grads_ref = (torch.load(ref_path, map_location="cpu", mmap=True,
                            weights_only=True) if dist.get_rank() == 0 else None)
    out: Dict[str, Any] = {"rank": dist.get_rank(), "arms": {}}
    arms = (("dp1xtp2 f32", (1, 2), torch.float32, False),
            ("dp2xtp1 f32", (2, 1), torch.float32, False),
            ("dp1xtp2 f32 remat", (1, 2), torch.float32, True),
            ("dp1xtp2 bf16", (1, 2), torch.bfloat16, False))
    for name, (dp, tp), dtype, remat in arms:
        mesh = make_mesh(dp=dp, tp=tp, arch=arch, device=dev)
        r = _meshed_step(mesh, arch, seed, 4, grads_ref, seconds, dtype, remat)
        c = r["counts"]
        _say_train(mesh, f"{name}: K2-fwd-res {c['K2-fwd-res']}, K2-dkv "
                         f"{c['K2-dkv']}, K2-dq {c['K2-dq']} launches, "
                         f"{r['heads']} local heads of {arch.encoder_heads}, "
                         f"{c['dout_copies']} output gradients copied")
        if dev.type == "cuda" and min(c["K2-fwd-res"], c["K2-dkv"], c["K2-dq"]) <= 0:
            raise RuntimeError(f"{name}: K2's training kernels not launched: {c}")
        if c["dout_copies"]:
            raise RuntimeError(f"{name}: {c['dout_copies']} output gradients "
                               "broke TMA's rule and were copied")
        if not r["f32_master"]:
            raise RuntimeError(f"{name}: the master weights left f32")
        if mesh.rank == 0 and dtype == torch.float32:
            want = ref["b"]["f32"]["loss"]
            if not abs(r["loss"] - want) <= 1e-5 * abs(want):
                raise RuntimeError(f"{name}: loss {r['loss']}, unsharded {want}")
            if not r["worst_leaf"][0] <= CARD_GRAD_REL:
                raise RuntimeError(f"{name}: gradient leaf {r['worst_leaf']}")
        if (mesh.rank == 0 and dtype == torch.bfloat16
                and not r["all_leaves"] <= BF16_RATIO * ref["b"]["bf16_vs_f32"]):
            raise RuntimeError(
                f"{name}: bf16 gradients {r['all_leaves']} from f32, the "
                f"unsharded bf16 step's {ref['b']['bf16_vs_f32']}")
        out["arms"][name] = r
    del grads_ref

    mesh = make_mesh(dp=1, tp=2, arch=sp_arch, device=dev)
    mel = LogMelFeaturizer(n_mels=sp_arch.n_mels, chunk_length_s=sp_seconds,
                           device=dev)(card_audio(CARD_SP_ROWS, sp_seconds, seed + 7))
    t = mel.shape[-1] // 2
    sp = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = card_model(sp_arch, dtype, seed, dev)
        _zero_train_counts()
        _reset_peak(dev)
        with torch.inference_mode():
            block, wall = _timed(lambda: encoder_forward(model, mel, seq=mesh))
            whole = gather_seq(mesh, block, t).float().cpu()
        c = _train_counts()
        _say_train(mesh, f"SP {name}: {block.shape[1]} of {t} time rows, K2 "
                         f"{c['K2']} launches")
        if dev.type == "cuda" and c["K2"] != sp_arch.encoder_layers:
            raise RuntimeError(f"SP {name}: K2 launched {c['K2']} times")
        dist_f32 = _rel_l2(whole, ref["c"]["f32"]["out"])
        bound = (CARD_SP_REL if dtype == torch.float32
                 else BF16_RATIO * ref["c"]["bf16_vs_f32"])
        if not dist_f32 <= bound:
            raise RuntimeError(f"SP {name}: {dist_f32} from the unsharded f32 "
                               f"encoder, bound {bound}")
        sp[name] = {"rows": block.shape[1], "of": t, "wall": wall,
                    "peak_gib": _peak_gib(dev), "vs_f32": dist_f32,
                    "bound": bound, "K2": c["K2"]}
        if dtype == torch.bfloat16:
            sp[name]["vs_unsharded_bf16"] = _rel_l2(whole, ref["c"]["bf16"]["out"])
        del model, block, whole
    out["sp"] = sp
    out["sp_grad"] = _card_sp_grad(mesh, sp_arch, sp_seconds, seed, ref_path,
                                   ref)
    return out


def _card_sp_grad(mesh, sp_arch, seconds: float, seed: int, ref_path: str,
                  ref) -> Dict[str, Any]:
    """(d) The sequence-parallel encoder's backward at tp 2 on whole
    ``sp_arch`` weights cut to ``CARD_SP_GRAD_LAYERS`` layers: f32 and a
    bf16 compute type over f32 weights (``_sp_grads``), rank 0 holding
    every gathered f32 leaf within ``CARD_GRAD_REL`` of the unsharded f32
    gradients and bf16 within ``BF16_RATIO`` x the unsharded bf16
    distance from them; K2-fwd-res, K2-dkv and K2-dq (a rank's queries
    over the gathered keys) launched once a layer, no output gradient
    copied; the leaves' digests for the parent to compare across ranks."""
    from thewhisper_tpu_torch.parallel import mesh as pm

    dev = mesh.device
    arch = dataclasses.replace(sp_arch, encoder_layers=min(
        sp_arch.encoder_layers, CARD_SP_GRAD_LAYERS))
    mel, cot = _sp_grad_inputs(arch, seconds, seed, dev)
    want = (torch.load(sp_grad_path(ref_path), map_location="cpu",
                       weights_only=True) if mesh.rank == 0 else None)
    model = card_model(arch, torch.float32, seed, dev).requires_grad_(True)
    out: Dict[str, Any] = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        _zero_train_counts()
        scatters = pm.REDUCE_SCATTERS
        _reset_peak(dev)
        grads, wall = _timed(lambda: _sp_grads(model, mel, cot, mesh, dtype))
        c = _train_counts()
        c["reduce_scatters"] = pm.REDUCE_SCATTERS - scatters
        r = {"wall": wall, "peak_gib": _peak_gib(dev), "counts": c,
             "digests": {n: _digest(g) for n, g in grads.items()}}
        _say_train(mesh, f"SP backward {name}: K2-fwd-res {c['K2-fwd-res']}, "
                         f"K2-dkv {c['K2-dkv']}, K2-dq {c['K2-dq']} launches, "
                         f"{c['reduce_scatters']} reduce-scatters, "
                         f"{c['dout_copies']} output gradients copied")
        layers = arch.encoder_layers
        if dev.type == "cuda" and not (c["K2-fwd-res"] == c["K2-dkv"]
                                       == c["K2-dq"] == layers):
            raise RuntimeError(f"SP backward {name}: launches {c}")
        if c["reduce_scatters"] != layers or c["dout_copies"]:
            raise RuntimeError(f"SP backward {name}: {c}")
        if mesh.rank == 0:
            if dtype is None:
                worst = max((_rel_l2(g.cpu(), want[n]), n) for n, g in grads.items())
                r["worst_leaf"] = worst
                if not worst[0] <= CARD_GRAD_REL:
                    raise RuntimeError(f"SP backward f32: gradient leaf {worst}")
            r["vs_f32"] = _rel_l2(_flat(grads, grads), _flat(want, grads))
            if dtype is not None:
                r["bound"] = BF16_RATIO * ref["d"]["bf16_vs_f32"]
                if not r["vs_f32"] <= r["bound"]:
                    raise RuntimeError(f"SP backward bf16: {r['vs_f32']} from "
                                       f"f32, bound {r['bound']}")
        out[name] = r
        del grads
    del model, mel, cot, want
    return out


def check_mesh_train(a, pair, arch=TRAIN_CARD_ARCH) -> None:
    """The parent's checks of [MESH_TRAIN]'s children: (a) bit for bit;
    (b) every rank's launches and local heads, the replicated leaves (and
    their gradients) the same bits on both tp ranks of each tp-2 arm, and
    every parameter the same bits on both dp ranks of the dp-2 arm; (d)
    the sequence-parallel encoder's summed gradients the same bits on
    both tp ranks."""
    if a["differ"]:
        raise RuntimeError(f"(a) the one-rank NCCL mesh differs from the "
                           f"unsharded step: {a['differ'][:8]}")
    for name in pair[0]["arms"]:
        x, y = (r["arms"][name] for r in pair)
        for r in (x, y):
            if r["heads"] != arch.encoder_heads // (2 if "tp2" in name else 1):
                raise RuntimeError(f"{name}: {r['heads']} local heads")
        keys = (("params",) if "dp2" in name
                else ("replicated", "replicated_params"))
        for k in keys:
            if x[k] != y[k]:
                bad = [n for n in x[k] if x[k][n] != y[k][n]]
                raise RuntimeError(f"{name}: {k} differ across ranks: {bad[:6]}")
    for name in pair[0]["sp_grad"]:
        x, y = (r["sp_grad"][name]["digests"] for r in pair)
        if x != y:
            bad = [n for n in x if x[n] != y[n]]
            raise RuntimeError(f"(d) SP backward {name}: summed gradients "
                               f"differ across the tp ranks: {bad[:6]}")
