"""The port's int4 "S4" mode against the JAX package's, on the CPU.

The bits-4 quantizers must give JAX's values (qmax 7, half to even) and
scales bit for bit; ``Int4Linear`` (its plain version here, Q4 on the card)
is held to JAX's ``_linear`` on the ``jnp.int4`` leaf; a JAX S4 tree (fused
self q/k/v included) carries across nibble for nibble; and the engines that
both packages build with ``from_checkpoint(quantize="int4")`` on the tiny
checkpoint give the same tokens, greedy, with beams and speculating, at
f32 (logprobs to 1e-4, summation order).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.config import GenerationOptions
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu.models import quant as jq
from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.engine import speculative as tspec
from thewhisper_tpu_torch.models import quant as tq
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.ops import int4_linear as q4
from thewhisper_tpu_torch.ops.mega_step import pack_mega_params

from _torch_tiny import ARCH, jax_params_numpy
from _torch_tiny import one_cpu_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    w = (0.02 * rng.standard_normal((3, 64, 96))).astype(np.float32)
    # Column 0 of layer 0 hits exact halves: max|w| = 7 gives scale 1, so
    # w / s lands on .5 and half-to-even decides (0.5 -> 0, 1.5 -> 2, ...).
    w[0, :, 0] = 0.0
    w[0, :8, 0] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -7.0]
    return w


def test_bits4_quantizers_match_jax():
    w = _weights()                                         # (L, in, out)
    ref = jq.quantize_weight(w, bits=4)
    q, s = tq.quantize_weight(_t(w).transpose(-1, -2), bits=4)
    assert ref["q"].dtype == jnp.int4 and q.dtype == torch.int8
    np.testing.assert_array_equal(q.transpose(-1, -2).numpy(),
                                  np.asarray(ref["q"], np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["s"]))
    assert q[0, 0, :8].tolist() == [7, 0, 2, 2, 0, -2, -2, -7]
    assert int(q.abs().max()) == 7
    emb = (0.02 * np.random.default_rng(1).standard_normal((200, 64))
           ).astype(np.float32)
    ref = jq.quantize_embedding(emb, bits=4)
    q, s = tq.quantize_embedding(_t(emb), bits=4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref["q"], np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["s"]))
    for bits in (3, 16):
        with pytest.raises(ValueError, match="4 or 8"):
            tq.quantize_weight(_t(w), bits=bits)
        with pytest.raises(ValueError, match="4 or 8"):
            jq.quantize_weight(w, bits=bits)


def test_pack_round_trip_over_every_nibble():
    q = torch.arange(-8, 8, dtype=torch.int8)
    rows = torch.stack([q, q.flip(0), q.roll(3)])          # (3, 16)
    packed = tq.pack_int4(rows)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 8)
    assert torch.equal(tq.unpack_int4(packed), rows)
    # Input 2j in the low nibble of byte j, 2j + 1 in the high one.
    assert packed[0, 0].item() == (-8 & 0xF) | ((-7 & 0xF) << 4)
    assert packed[0, 4].item() == 0 | (1 << 4)
    assert sorted(set(tq.pack_int4(torch.tensor([[a, b] for a in range(-8, 8)
                                                for b in range(-8, 8)],
                                               dtype=torch.int8)).view(-1)
                      .tolist())) == list(range(256))
    with pytest.raises(ValueError, match="odd"):
        tq.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_int4_linear_matches_jax_linear(dtype, bias):
    """The plain Int4Linear against JAX's ``_linear`` on the int4 leaf:
    f32 to rtol 1e-5; bf16 within bf16's rounding."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    w = (0.05 * rng.standard_normal((64, 48))).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    lin = torch.nn.Linear(64, 48, bias=bias, dtype=dtype)
    lin.weight.data = _t(w.T).to(dtype)
    if bias:
        lin.bias.data = _t(b).to(dtype)
    mod = tq.Int4Linear.from_linear(lin)
    assert mod.weight.shape == (48, 32) and mod.weight.dtype == torch.uint8
    leaf = jq.quantize_weight(np.asarray(jnp.asarray(w, jdt), np.float32), bits=4)
    np.testing.assert_array_equal(tq.unpack_int4(mod.weight).T.numpy(),
                                  np.asarray(leaf["q"], np.int8))
    ref = jw._linear(jnp.asarray(x, jdt), leaf,
                     jnp.asarray(b, jdt) if bias else None)
    got = mod(_t(x).to(dtype))
    assert got.dtype == dtype
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


def test_q4_launch_plan_and_refusals():
    """Q4's launch (the decode route up to ``DECODE_MAX_ROWS`` rows, split-K
    clusters where N / 16 blocks leave SMs idle; the tiled route above; the
    f32 route's warps dividing K / 128) and the shapes and operands its
    wrapper refuses."""
    Plan = q4.Plan
    assert q4.plan(1, 1280, 1280, 132) == Plan("decode", 10, 1, 1, 1, (1, 80), True)
    assert q4.plan(8, 5120, 1280, 132) == Plan("decode", 10, 1, 1, 1, (1, 320), True)
    assert q4.plan(1, 1280, 5120, 132) == Plan("decode", 10, 1, 1, 4, (4, 80), True)
    assert q4.plan(9, 1280, 1280, 132) == Plan("decode", 5, 4, 2, 1, (1, 80), True)
    assert q4.plan(32, 3840, 1280, 132) == Plan("decode", 4, 4, 3, 1, (1, 240), True)
    assert q4.plan(32, 5120, 1280, 132) == Plan("tiled", 9, 4, 0, 1, (40, 1))
    assert q4.plan(32, 1280, 5120, 132) == Plan("tiled", 9, 4, 0, 4, (40, 1))
    assert q4.plan(160, 1280, 1280, 132) == Plan("tiled", 9, 4, 0, 1, (10, 5))
    assert q4.plan(1500, 1280, 5120, 132) == Plan("tiled", 9, 16, 0, 1, (10, 12), True)
    assert q4.plan(6000, 5120, 1280, 132) == Plan("tiled", 9, 16, 0, 1, (40, 47), True)
    assert q4.plan(1, 1280, 1280, 132, f32=True) == Plan("f32", 5, 1, 0, 1, (80, 1))
    assert q4.plan(1500, 1280, 1280, 132, f32=True) == Plan("f32", 5, 4, 0, 1, (80, 7))
    edge = q4.DECODE_MAX_ROWS
    assert q4.plan(edge, 1280, 1280, 132).route == "decode"
    assert q4.plan(edge + 1, 1280, 1280, 132).route == "tiled"
    # A block's k-blocks past 16 warps x 2 (8 x 4) in registers, split 8
    # ways, go to the tiled route.
    assert q4.plan(1, 16, 128 * 256, 132) == Plan("decode", 16, 1, 2, 8, (8, 1), True)
    assert q4.plan(1, 16, 128 * 257, 132) == Plan("tiled", 9, 4, 0, 4, (4, 1))
    for m, n, k in ((1, 1288, 1280), (1, 1280, 1300), (0, 1280, 1280)):
        with pytest.raises(ValueError, match="int4_linear"):
            q4.plan(m, n, k, 132)
    x = torch.zeros(3, 256)
    w = torch.zeros(32, 128, dtype=torch.uint8)
    s, b = torch.ones(32), torch.zeros(32)
    q4._check(x, w, s, b)
    for args in ((x.half(), w, s, b), (x, w[:, :64], s, b),
                 (x, w.to(torch.int8), s, b), (x, w, s.double(), b),
                 (x, w, s, b.bfloat16()), (x.t().contiguous().t(), w, s, b),
                 (torch.zeros(256, 3).t(), w, s, None)):
        with pytest.raises(ValueError, match="int4_linear"):
            q4._check(*args)


LARGE_V3_LINEARS = ((3840, 1280), (1280, 1280), (5120, 1280), (1280, 5120))


def _simulate(p, m, n, k):
    """A launch of plan ``p`` as ``csrc/int4_linear.cu`` indexes it: (the
    output rows of each block, the x rows of each block, for each output
    row the k-blocks in the order their sums are added, each as (cluster
    rank, warp, k-block)). Checks the grid's limits on the way."""
    kblocks = k // q4.BLOCK_K
    gx, gy = p.grid
    assert 1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= 65535
    if p.route == "tiled":
        bn = 8 * p.nt
        assert p.warps == 9 and bn in (32, 128) and p.split in (1, 2, 4, 8)
        assert p.split <= kblocks and gx == p.split * -(-n // q4.TILE)
        assert gy == -(-m // bn)
        # Block x = tile * split + rank: the tile's rows, the rank's stages;
        # the cluster's partials added in rank order.
        rows = [range(bx // p.split * q4.TILE, min(n, (bx // p.split + 1) * q4.TILE))
                for bx in range(0, gx, p.split)]
        xrows = [range(by * bn, min(m, (by + 1) * bn)) for by in range(gy)]
        seq = [(rank, 0, kt) for rank in range(p.split)
               for kt in range(rank * kblocks // p.split, (rank + 1) * kblocks // p.split)]
        order = {f: seq for f in range(n)}
        return rows, xrows, order
    assert p.route == "decode" and p.split in (1, 2, 4, 8) and gx == p.split
    limit = 16 if p.nt == 1 and p.kpw <= 2 else 8
    assert 1 <= p.warps <= limit and 1 <= p.kpw <= 4 and p.nt in (1, 4)
    assert p.split <= kblocks and gy * 16 == n
    rows, order = [], {}
    for b in range(gy):
        rows.append(range(16 * b, 16 * b + 16))
        seq = []
        for rank in range(p.split):  # the cluster's partials in rank order
            kb0, kb1 = rank * kblocks // p.split, (rank + 1) * kblocks // p.split
            for warp in range(p.warps):  # a block's warps in order
                for j in range(p.kpw):  # a warp's k-blocks in order
                    kb = kb0 + warp + j * p.warps
                    if kb < kb1:
                        seq.append((rank, warp, kb))
        for f in rows[-1]:
            order[f] = seq
    tile = 8 * p.nt
    xrows = [range(0, -(-m // tile) * tile)]  # every block sweeps every M-tile
    return rows, xrows, order


@pytest.mark.parametrize("m", [1, 4, 32, 33, 160, 1500, 6000])
def test_q4_plans_cover_every_output_and_column_once(m):
    """Every plan of large-v3's linears at 132 SMs, simulated: each output
    row, x row and k-block once, the split-K partials in rank order (one
    order, whatever order the blocks finish in), the grid within limits."""
    for n, k in LARGE_V3_LINEARS:
        p = q4.plan(m, n, k, 132)
        rows, xrows, order = _simulate(p, m, n, k)
        assert sorted(f for r in rows for f in r) == list(range(n))
        covered = sorted(i for r in xrows for i in r)
        assert covered[:m] == list(range(m)) and len(set(covered)) == len(covered)
        assert len(order) == n
        for seq in order.values():
            assert sorted(kb for _, _, kb in seq) == list(range(k // q4.BLOCK_K))
            assert seq == sorted(seq, key=lambda s: s[:2])


def _s4_tree(tree, fuse=True):
    params = jq.quantize_params(tree, components=("decoder",), bits=4)
    if fuse:
        params = jw.fuse_self_qkv_params(params)
    return jax.tree.map(np.asarray, params)


def test_quantized_bytes_match_jax():
    tree = jax_params_numpy()
    model = tq.quantize_params(params_from_jax(tree, ARCH), bits=4)
    assert type(model.decoder.layers[0].fc1) is tq.Int4Linear
    assert type(model.decoder.token_emb) is tq.Int8Embedding
    assert type(model.encoder.layers[0].fc1) is torch.nn.Linear
    ref = jq.quantize_params(tree, components=("decoder",), bits=4)
    assert tq.quantized_bytes(model) == jq.quantized_bytes(ref)
    s = tq.quantize_params(params_from_jax(tree, ARCH))
    assert tq.quantized_bytes(model) < tq.quantized_bytes(s)


def test_params_from_jax_s4_tree_equals_the_ports_own():
    """JAX's S4 tree, its self q/k/v fused, carried across; and the port's
    own quantize_params + fuse_self_qkv on the float weights: the same
    modules, nibble for nibble."""
    tree = jax_params_numpy()
    theirs = params_from_jax(_s4_tree(tree), ARCH)
    ours = tw.fuse_self_qkv(tq.quantize_params(params_from_jax(tree, ARCH),
                                               bits=4))
    fused = ours.decoder.layers[0].self_attn.qkv
    assert type(fused) is tq.Int4Linear and fused.weight.shape == (192, 32)
    # params_from_jax splits the fused leaf back into q, k and v.
    tw.fuse_self_qkv(theirs)
    sd, ref = ours.state_dict(), theirs.state_dict()
    assert sd.keys() == ref.keys()
    for name in sd:
        assert sd[name].dtype == ref[name].dtype, name
        torch.testing.assert_close(sd[name], ref[name], atol=0, rtol=0, msg=name)
    for name, mod in ours.named_modules():
        assert type(mod) is type(theirs.get_submodule(name)), name
    # The unfused tree gives the same q, k and v.
    unfused = params_from_jax(_s4_tree(tree, fuse=False), ARCH)
    for n in "qkv":
        a = getattr(unfused.decoder.layers[1].self_attn, n)
        assert type(a) is tq.Int4Linear
        torch.testing.assert_close(
            a.weight, tq.quantize_params(params_from_jax(tree, ARCH), bits=4)
            .decoder.layers[1].self_attn.get_submodule(n).weight, atol=0, rtol=0)


def test_s4_decoder_never_takes_k3_or_k4():
    """pack_mega_params returns None for int4 linears, as JAX's does for
    non-int8 leaves; the engine leaves ``model.mega`` None."""
    tree = jax_params_numpy()
    model = tw.fuse_self_qkv(tq.quantize_params(params_from_jax(tree, ARCH),
                                                bits=4))
    assert pack_mega_params(model) is None and model.mega is None
    WhisperEngine(model, cross_kv_int8=True)
    assert model.mega is None
    jtree = _s4_tree(tree)
    from thewhisper_tpu.ops.mega_step import MEGA_KEY
    from thewhisper_tpu.ops.mega_step import pack_mega_params as jax_pack

    assert MEGA_KEY not in jax_pack(jtree, ARCH)["decoder"]


def test_save_draft_refuses_int4(tmp_path):
    model = tq.quantize_params(params_from_jax(jax_params_numpy(), ARCH), bits=4)
    draft = tspec.make_layer_skip_draft(model, 1)
    assert type(draft.decoder.layers[0].fc2) is tq.Int4Linear
    with pytest.raises(ValueError, match="int4"):
        tspec.save_draft(str(tmp_path / "d"), draft)
    assert not (tmp_path / "d.npz").exists()


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    sys.path.insert(0, "tools")
    from make_tiny_checkpoint import make_checkpoint

    return make_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny"), seed=3)


def _same(out, ref):
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    for i, n in enumerate(ref.num_generated):
        upto = min(int(n) + 1, ref.token_logprobs.shape[1])
        np.testing.assert_allclose(out.token_logprobs[i, :upto],
                                   ref.token_logprobs[i, :upto], atol=1e-4)


@pytest.mark.parametrize("draft", [None, "ngram", "layer-skip:1", "checkpoint"])
def test_s4_engine_matches_jax(tiny_ckpt, draft):
    """``from_checkpoint(quantize="int4")`` at f32 in both packages: int4
    decoder linears, an int8 table, int8 cross K/V; JAX's tokens greedy
    (and with three beams), and speculating, where they also equal the
    port's greedy tokens. A layer-skip draft keeps the target's int4
    layers; a checkpoint draft is quantized to int8."""
    path = tiny_ckpt if draft == "checkpoint" else draft
    opts = GenerationOptions(max_new_tokens=8, language="en")
    kw = dict(chunk_length_s=10, quantize="int4", draft=path, spec_window=2)
    ref_eng = JaxEngine.from_checkpoint(tiny_ckpt, compute_dtype=jnp.float32,
                                        **kw)
    eng = WhisperEngine.from_checkpoint(tiny_ckpt, compute_dtype=torch.float32,
                                        device="cpu", **kw)
    mel = np.random.default_rng(9).standard_normal(
        (2, eng.arch.n_mels, 60)).astype(np.float32)
    assert eng.cross_kv_int8 and eng.model.mega is None
    layer = eng.model.decoder.layers[0]
    assert type(layer.self_attn.qkv) is tq.Int4Linear
    assert type(layer.fc1) is tq.Int4Linear
    assert type(eng.model.decoder.token_emb) is tq.Int8Embedding
    assert type(eng.model.encoder.layers[0].fc1) is torch.nn.Linear
    out = eng.transcribe_features(mel, opts)
    _same(out, ref_eng.transcribe_features(mel, opts))
    if draft is None:
        assert out.spec_rounds is None and int(out.num_generated.max()) > 1
        beams = GenerationOptions(max_new_tokens=8, language="en", num_beams=3)
        got = eng.transcribe_features(mel, beams)
        ref = ref_eng.transcribe_features(mel, beams)
        _same(got, ref)
        np.testing.assert_allclose(got.sum_logprob, ref.sum_logprob, atol=1e-4)
        return
    assert out.spec_rounds > 0
    greedy = WhisperEngine.from_checkpoint(
        tiny_ckpt, compute_dtype=torch.float32, device="cpu", chunk_length_s=10,
        quantize="int4").transcribe_features(mel, opts)
    np.testing.assert_array_equal(out.tokens, greedy.tokens)
    if draft == "ngram":
        assert eng.draft_model is None
        return
    fc1 = eng.draft_model.decoder.layers[0].fc1
    if draft == "layer-skip:1":
        assert type(fc1) is tq.Int4Linear and fc1 is layer.fc1
    else:
        assert type(fc1) is tq.Int8Linear
