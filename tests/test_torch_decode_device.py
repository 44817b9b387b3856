"""The decode loop on device state against the JAX package, at f32 on the CPU.

``decoder_step`` takes its position as a device tensor (JAX's device
scalar) and attends every cache slot under the mask ``slot < position``;
``greedy_decode`` keeps its state in tensors and gates every write of a
step on "step < max_new and not all done", so the host may read the stop
flag once every k steps without changing any output; the engine pads a
batch up to its bucket as JAX's does. Tolerances are those of
``tests/test_torch_model.py`` (1e-4 on logits, 1e-5 on alignment) and
``tests/test_torch_pipeline.py`` (engine numbers); tokens are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.config import GenerationOptions
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu.engine.decode import greedy_decode as jax_greedy
from thewhisper_tpu.engine.decode import suppress_mask as jax_suppress_mask
from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu_torch.config import WhisperArch
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.engine import decode as td
from thewhisper_tpu_torch.models import quant as tq
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.ops import mega_step as tm

from _torch_tiny import ARCH, SPECIAL, SUPPRESS, jax_params_numpy
from _torch_tiny import one_cpu_thread  # noqa: F401

PROMPT = np.asarray([[102, 110, 121, 123], [102, 111, 121, 123]], np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def both():
    tree = jax_params_numpy()
    return tree, params_from_jax(tree, ARCH, dtype=torch.float32)


def _enc(tree, batch=2, seed=2):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((batch, ARCH.n_mels, 300)).astype(np.float32)
    return np.asarray(jw.encoder_forward(tree, jnp.asarray(mel), ARCH))


STEP_TOKENS = np.asarray([[5, 7], [9, 11], [13, 15]], np.int32)
STEP_SLOTS = 10


@pytest.fixture(scope="module")
def jax_steps(both):
    """JAX's decoder_step after the prompt's prefill at slots 4, 6 and 8
    (the gaps stay 0): each step's (logits, align), the final cache, and
    the encoder output they attend."""
    tree, _ = both
    enc = _enc(tree)
    ck, cv = jw.compute_cross_kv(tree, jnp.asarray(enc), ARCH)
    jcache = jw.make_cache(ARCH, 2, STEP_SLOTS, ck, cv)
    _, jcache, _ = jw.decoder_prefill(tree, jnp.asarray(PROMPT), jcache, ARCH)
    steps = []
    for i, tok in enumerate(STEP_TOKENS):
        jl, jcache, ja = jw.decoder_step(
            tree, jnp.asarray(tok[:, None]), jnp.int32(PROMPT.shape[1] + 2 * i),
            jcache, ARCH)
        steps.append((np.asarray(jl), np.asarray(ja)))
    return enc, steps, jcache


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_decoder_step_at_device_position_matches_jax(both, jax_steps, dtype):
    """Three steps at positions held in (1,) tensors against JAX's
    decoder_step: logits, alignment and the written slots; the same steps
    at host ints give the same bits."""
    _, model = both
    enc, ref_steps, jcache = jax_steps
    tk, tv = tw.compute_cross_kv(model, _t(enc))
    caches = [tw.make_cache(ARCH, 2, STEP_SLOTS, tk, tv) for _ in range(2)]
    for c in caches:
        tw.decoder_prefill(model, _t(PROMPT).long(), c)
    for i, (tok, (jl, ja)) in enumerate(zip(STEP_TOKENS, ref_steps)):
        pos = PROMPT.shape[1] + 2 * i
        tl, _, ta = tw.decoder_step(model, _t(tok[:, None]).long(),
                                    torch.tensor([pos], dtype=dtype), caches[0])
        hl, _, ha = tw.decoder_step(model, _t(tok[:, None]).long(), pos,
                                    caches[1])
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4)
        np.testing.assert_allclose(ta.numpy(), ja, atol=1e-5)
        assert torch.equal(tl, hl) and torch.equal(ta, ha)
    for got, ref in ((caches[0].self_k, jcache.self_k),
                     (caches[0].self_v, jcache.self_v)):
        np.testing.assert_allclose(got.numpy(), np.swapaxes(np.asarray(ref), 3, 4),
                                   atol=1e-4)
    assert torch.equal(caches[0].self_k, caches[1].self_k)


def _greedy(model, tree, eot, batch, k, max_new=12):
    enc = _enc(tree, batch=2)[:batch]
    tk, tv = tw.compute_cross_kv(model, _t(enc))
    cache = tw.make_cache(ARCH, batch, 4 + max_new, tk, tv)
    sup = _t(jax_suppress_mask(ARCH.vocab_size, SUPPRESS))
    return td.greedy_decode(model, _t(PROMPT[:batch]).long(), cache, max_new,
                            eot, suppress=sup, capture_alignment=True,
                            no_speech_id=SPECIAL.no_speech, steps_per_check=k)


@pytest.fixture(scope="module")
def varied():
    """The tiny model with its decoder position table ten times larger: the
    random decoder then emits a different token at most steps (at 1x it
    repeats one token), so an EOT can be chosen that stops a row early."""
    tree = jax_params_numpy()
    tree["decoder"]["pos_emb"] = tree["decoder"]["pos_emb"] * 10.0
    return tree, params_from_jax(tree, ARCH, dtype=torch.float32)


@pytest.mark.parametrize("batch", [1, 2])
def test_host_check_interval_changes_no_output(varied, batch):
    """The host reads the stop flag every k = 1, 3 or 7 steps: every output
    is bitwise the same, the tails past the stop included (EOT is a token
    row 0 first emits at step 2 or later, so row 0 stops early and, at
    batch 1, the loop with it), and the tokens are JAX's."""
    tree, model = varied
    gen = _greedy(model, tree, eot=-1, batch=batch, k=8).tokens[0, 4:].tolist()
    stop = next(j for j in range(2, 12) if gen[j] not in gen[:j])
    eot = gen[stop]
    runs = [_greedy(model, tree, eot, batch, k) for k in (1, 3, 7)]
    assert int(runs[0].num_generated[0]) == stop
    if batch == 1:
        assert runs[0].steps == stop and runs[2].steps == 7 * -(-stop // 7)
    for r in runs[1:]:
        for name in ("tokens", "num_generated", "sum_logprob", "align",
                     "token_logprobs", "no_speech_prob"):
            assert torch.equal(getattr(r, name), getattr(runs[0], name)), name
    enc = _enc(tree, batch=2)[:batch]
    ck, cv = jw.compute_cross_kv(tree, jnp.asarray(enc), ARCH)
    jcache = jw.make_cache(ARCH, batch, 16, ck, cv)
    ref = jax_greedy(jax.tree.map(jnp.asarray, tree), ARCH,
                     jnp.asarray(PROMPT[:batch]), jcache, 12, eot,
                     suppress=jnp.asarray(jax_suppress_mask(ARCH.vocab_size,
                                                            SUPPRESS)),
                     capture_alignment=True, no_speech_id=SPECIAL.no_speech)
    np.testing.assert_array_equal(runs[0].tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(runs[0].num_generated.numpy(),
                                  np.asarray(ref.num_generated))
    np.testing.assert_allclose(runs[0].align.numpy(), np.asarray(ref.align),
                               atol=1e-5)
    np.testing.assert_allclose(runs[0].token_logprobs.numpy(),
                               np.asarray(ref.token_logprobs), atol=1e-4)


def test_bucketed_engine_matches_jax(both):
    """Batch 3 on buckets (1, 2, 4): both engines decode four rows (a zero
    mel in the last) and return three; tokens exactly, the numbers to
    tests/test_torch_pipeline.py's tolerances. The port keeps one program
    for the bucket."""
    tree, _ = both
    jax_eng = JaxEngine(tree, ARCH, special=SPECIAL, batch_buckets=(1, 2, 4),
                        suppress_tokens=SUPPRESS)
    eng = WhisperEngine(params_from_jax(tree, ARCH, dtype=torch.float32),
                        special=SPECIAL, suppress_tokens=SUPPRESS,
                        batch_buckets=(1, 2, 4))
    mel = np.random.default_rng(7).standard_normal(
        (3, ARCH.n_mels, 300)).astype(np.float32)
    opts = GenerationOptions(max_new_tokens=8, language="en",
                             return_timestamps=True)
    ref = jax_eng.transcribe_features(mel, opts)
    out = eng.transcribe_features(mel, opts)
    assert out.tokens.shape == ref.tokens.shape == (3, 12)
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    np.testing.assert_allclose(out.align, ref.align, atol=1e-5)
    np.testing.assert_allclose(out.sum_logprob, ref.sum_logprob, atol=1e-4)
    np.testing.assert_allclose(out.token_logprobs, ref.token_logprobs, atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob, ref.no_speech_prob, atol=1e-6)
    assert [p["key"] for p in eng.programs()] == [(4, 300, 4, 8, True, 1)]
    again = eng.transcribe_features(mel[:2], opts)       # bucket 2: a new key
    np.testing.assert_array_equal(again.tokens.shape, (2, 12))
    assert len(eng.programs()) == 2


def test_engine_keeps_the_programs_used_last(both, monkeypatch):
    """With room for two programs a third static shape frees the program
    used least recently; a shape made again decodes as before. An int8
    engine computes and quantizes the cross K/V into its program a layer
    at a time, with the bits of ``quantize_kv`` over the whole stack."""
    from thewhisper_tpu_torch.engine import engine as te

    tree, model = both
    monkeypatch.setattr(te, "MAX_PROGRAMS", 2)
    eng = WhisperEngine(model, special=SPECIAL, suppress_tokens=SUPPRESS,
                        batch_buckets=(1, 2, 4), cross_kv_int8=True)
    mel = np.random.default_rng(7).standard_normal(
        (3, ARCH.n_mels, 300)).astype(np.float32)
    opts = GenerationOptions(max_new_tokens=6, language="en",
                             return_timestamps=True)
    first = eng.transcribe_features(mel[:1], opts)
    eng.transcribe_features(mel[:2], opts)
    eng.transcribe_features(mel[:1], opts)               # bucket 1 used last
    eng.transcribe_features(mel, opts)                   # frees bucket 2
    assert [p["key"][0] for p in eng.programs()] == [1, 4]
    again = eng.transcribe_features(mel[:1], opts)
    assert [p["key"][0] for p in eng.programs()] == [4, 1]
    for name in ("tokens", "sum_logprob", "token_logprobs", "align"):
        np.testing.assert_array_equal(getattr(again, name), getattr(first, name))
    with torch.inference_mode():
        enc = tw.encoder_forward(model, _t(mel[:1]))
        ck, cv = (tq.quantize_kv(x) for x in tw.compute_cross_kv(model, enc))
        cache = tw.make_cache(ARCH, 1, 4 + 6, ck, cv, dtype=torch.float32)
        prompt = torch.tensor([eng.build_prompt("en")])
        ref = td.greedy_decode(model, prompt, cache, 6, SPECIAL.eot,
                               suppress=eng._suppress, capture_alignment=True,
                               no_speech_id=SPECIAL.no_speech)
    prog = eng._programs[(1, 300, 4, 6, True, 1)].cache
    for got, want in ((prog.cross_k, ck), (prog.cross_v, cv)):
        assert torch.equal(got.q, want.q) and torch.equal(got.s, want.s)
    np.testing.assert_array_equal(first.tokens, ref.tokens.numpy())
    np.testing.assert_array_equal(first.sum_logprob, ref.sum_logprob.numpy())


class _RunningGraph:
    """``engine.graphs.StepGraph`` for the CPU: the warm-up step runs, and
    each replay runs the steps a capture would have recorded."""

    def __init__(self, run, warm, device):
        warm()
        self.run, self.bytes, self.launches = run, 0, 0

    def replay(self):
        self.run()


@pytest.mark.parametrize("beams", [1, 2])
def test_engine_graph_route_matches_eager(both, monkeypatch, beams):
    """The engine's graph route (the loop parked, one warm-up step, then
    replays of STEPS_PER_CHECK steps from the device state) on the CPU,
    with the graph run by ``_RunningGraph``: every output equal to the
    eager engine's, on a second call of the key as on the first."""
    from thewhisper_tpu_torch.engine import engine as te

    _, model = both
    mel = np.random.default_rng(5).standard_normal(
        (3, ARCH.n_mels, 300)).astype(np.float32)
    opts = GenerationOptions(max_new_tokens=7, language="en", num_beams=beams,
                             return_timestamps=True)
    eager = WhisperEngine(model, special=SPECIAL, suppress_tokens=SUPPRESS,
                          batch_buckets=(1, 2, 4))
    ref = [eager.transcribe_features(m, opts) for m in (mel, mel[::-1])]
    monkeypatch.setattr(te, "StepGraph", _RunningGraph)
    graphed = WhisperEngine(model, special=SPECIAL, suppress_tokens=SUPPRESS,
                            batch_buckets=(1, 2, 4))
    graphed.cuda_graphs = True
    for m, r in zip((mel, mel[::-1]), ref):
        out = graphed.transcribe_features(m, opts)
        for name in ("tokens", "num_generated", "sum_logprob",
                     "token_logprobs", "no_speech_prob", "align"):
            np.testing.assert_array_equal(getattr(out, name),
                                          getattr(r, name), name)
    assert [p["graph"] for p in graphed.programs()] == [True]


K3_ARCH = WhisperArch(
    d_model=384, encoder_layers=1, encoder_heads=6, decoder_layers=2,
    decoder_heads=6, d_ff=1536, n_mels=80, vocab_size=500,
    max_source_positions=96, max_target_positions=64,
    alignment_heads=((0, 1), (1, 3)))


@pytest.fixture(scope="module")
def packed():
    g = torch.Generator().manual_seed(0)
    model = tw.init_params(K3_ARCH, g, dtype=torch.bfloat16, bias_std=0.1)
    tq.quantize_params(model)
    tm.pack_mega_params(tw.fuse_self_qkv(model))
    ck, cv = (tq.quantize_kv(torch.randn(2, 1, 6, 96, 64, generator=g))
              for _ in range(2))
    cache = tw.make_cache(K3_ARCH, 1, 20, ck, cv, dtype=torch.bfloat16)
    for t in (cache.self_k, cache.self_v):
        t.copy_(0.5 * torch.randn(t.shape, generator=g))
    return model, cache


def _copy(cache):
    return tw.DecodeCache(cache.self_k.clone(), cache.self_v.clone(),
                          cache.cross_k, cache.cross_v)


@pytest.mark.parametrize("pos", [0, 7, 19])
def test_mega_plain_takes_a_device_position(packed, pos):
    """K3's and K4's plain versions (what CPU tensors take) at a slot held
    in a tensor give the bits they give at the host int, cache included,
    and so does the K3 route's step."""
    model, cache = packed
    mp = model.mega
    x = tw.embed_tokens(model, torch.tensor([[17]]), pos)[:, 0]
    a, b = _copy(cache), _copy(cache)
    la, aa = tm.mega_step_plain(mp, x, pos, a, K3_ARCH)
    lb, ab = tm.mega_step_plain(mp, x, torch.tensor([pos], dtype=torch.int32),
                                b, K3_ARCH)
    assert torch.equal(la, lb) and torch.equal(aa, ab)
    assert torch.equal(a.self_k, b.self_k) and torch.equal(a.self_v, b.self_v)
    w = min(3, 20 - pos)
    xw = tw.embed_tokens(model, torch.arange(17, 17 + w)[None], pos)[0]
    va = tm.mega_verify_plain(mp, xw, pos, _copy(cache), K3_ARCH)
    vb = tm.mega_verify_plain(mp, xw, torch.tensor([pos]), _copy(cache), K3_ARCH)
    assert torch.equal(va, vb)
    token = torch.tensor([[17]])
    sa = tm.mega_decoder_step(model, token, pos, _copy(cache))
    sb = tm.mega_decoder_step(model, token, torch.tensor([pos]), _copy(cache))
    assert torch.equal(sa[0], sb[0]) and torch.equal(sa[2], sb[2])
    assert torch.equal(sa[0], la)


def test_k3_route_host_check_interval_changes_no_output(packed):
    """The batch-1 bf16 greedy loop through the K3 route (its plain version
    here), k = 1 and 5: the same bits; every step a K3 step."""
    model, cache = packed
    eng_eot = 3
    outs = []
    for k in (1, 5):
        fresh = tw.make_cache(K3_ARCH, 1, 4 + 9, cache.cross_k, cache.cross_v,
                              dtype=torch.bfloat16)
        loop = td.GreedyLoop(model, fresh, 4, 9, eng_eot,
                             capture_alignment=True)
        assert loop.mega
        loop.start(torch.tensor([[1, 2, 3, 4]]))
        loop.run(k)
        outs.append(loop.result())
    for name in ("tokens", "num_generated", "sum_logprob", "align",
                 "token_logprobs"):
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name)), name


def test_engine_graph_flag_is_card_only(both):
    """A CPU engine runs the steps eagerly whatever ``cuda_graphs`` says;
    a loop's host check needs a positive interval."""
    tree, model = both
    assert not WhisperEngine(model, cuda_graphs=True).cuda_graphs
    with pytest.raises(ValueError, match="steps_per_check"):
        _greedy(model, tree, eot=-1, batch=1, k=0)
