"""The port's probe kernels (P1-P5) on the CPU against the JAX package's.

Inputs are made with numpy from a seed and go to both sides. The JAX probes
live in ``tools/``, which is not a package, so they are imported by path:

- P2/P3: the plain ``mlp_chain``/``mlp_layer`` against the Pallas kernels of
  ``tools/gemv_chain_probe.py`` in interpret mode;
- P1: the plain ``attention_control`` against a numpy transcription of
  ``control_kernel`` (``tools/attention_probe.py:82-107``), whose kernel is
  built inside the probe's ``main``;
- P4/P5: the plain writes against ``jax.lax.dynamic_update_slice``, the
  probes' own XLA arms, with host slots and with one-element int32 tensor
  slots against a traced slot passed as the TPU kernels take it, and the
  16-write loop on a tensor index against ``fori_loop``'s device index.

Then each probe entry point runs with ``--device cpu`` and prints its JSON
line. The kernels themselves need the card: ``tests/test_torch_kernels.py``
holds them against these plain versions there (it imports no JAX, which
that machine lacks).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu_torch.ops import attention_control as ac
from thewhisper_tpu_torch.ops import cache_write as cw
from thewhisper_tpu_torch.ops import mlp_chain as mc
from thewhisper_tpu_torch.tools import (
    attention_probe,
    cache_write_probe,
    gemv_chain_probe,
    mega_caps_probe,
)

from _torch_tiny import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_probe(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides (round to nearest even from f32)."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# --- P2 / P3: the int8 MLP chain --------------------------------------------

L, D, F, TILE = 2, 256, 1024, 256


def _mlp_inputs(seed: int = 0):
    """The probe's operand kinds with random LayerNorm parameters, as numpy:
    (x f32 before its bf16 rounding, the eight operands in order)."""
    rng = np.random.default_rng(seed)
    ops = {
        "ln_s": (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32),
        "ln_b": (0.1 * rng.standard_normal((L, D))).astype(np.float32),
        "s1": (rng.uniform(0.5, 1.5, (L, F)) * 0.02 / 127).astype(np.float32),
        "b1": (0.02 * rng.standard_normal((L, F))).astype(np.float32),
        "s2": (rng.uniform(0.5, 1.5, (L, D)) * 0.02 / 127).astype(np.float32),
        "b2": (0.02 * rng.standard_normal((L, D))).astype(np.float32),
        "w1": rng.integers(-127, 128, (L, D, F)).astype(np.int8),
        "w2": rng.integers(-127, 128, (L, F, D)).astype(np.int8),
    }
    x = (0.1 * rng.standard_normal((1, D))).astype(np.float32)
    return x, [ops[k] for k in ("ln_s", "ln_b", "s1", "b1", "s2", "b2", "w1", "w2")]


def test_mlp_chain_plain_matches_the_jax_pallas_kernels():
    """The plain chain and layer against build_mlp_chain_kernel and
    build_mlp_layer_kernel in interpret mode: within 1e-2 of the largest
    value (the two round the same bf16 points; the sums run in another order
    and the GELU in another precision)."""
    probe = _jax_probe("gemv_chain_probe")
    x, ops = _mlp_inputs()
    xj, xt = _bf16(x)
    opj = [jnp.asarray(o) for o in ops]
    opt = [torch.from_numpy(o) for o in ops]

    chain_j = probe.build_mlp_chain_kernel(L, TILE, D, F, interpret=True)(xj, *opj)
    chain_t = mc.mlp_chain_plain(xt, *opt)
    assert chain_t.shape == (1, D) and chain_t.dtype == torch.bfloat16
    assert _rel(chain_t.float(), chain_j.astype(jnp.float32)) < 1e-2

    layer_fn = probe.build_mlp_layer_kernel(TILE, D, F, interpret=True)
    yj, yt = xj, xt
    for l in range(L):
        yj = layer_fn(yj, jnp.int32(l), *opj)
        yt = mc.mlp_layer(yt, l, *opt)
    assert _rel(yt.float(), yj.astype(jnp.float32)) < 1e-2
    # The port's layer-by-layer composition is its chain, bit for bit.
    assert torch.equal(yt, chain_t)


def test_mlp_layer_plain_matches_one_jax_layer():
    probe = _jax_probe("gemv_chain_probe")
    x, ops = _mlp_inputs(seed=1)
    xj, xt = _bf16(x)
    layer_fn = probe.build_mlp_layer_kernel(TILE, D, F, interpret=True)
    for l in range(L):
        want = layer_fn(xj, jnp.int32(l), *[jnp.asarray(o) for o in ops])
        got = mc.mlp_layer_plain(xt, l, *[torch.from_numpy(o) for o in ops])
        assert _rel(got.float(), want.astype(jnp.float32)) < 1e-2


# --- P1: the no-exp attention control ---------------------------------------


def _control_numpy(q, k, v, tile, round_p):
    """``control_kernel`` transcribed: per query tile and key tile in order,
    s = q k^T, m_new = max(m, rowmax(s)), p = s - m_new, l += rowsum(p),
    acc += p (rounded to bf16 when ``round_p``) @ v; out = acc / max(l, 1).
    Rows are independent, so all query rows run at once."""
    q, k, v = (np.asarray(t, np.float32) for t in (q, k, v))
    m = np.full(q.shape[:-1] + (1,), -1e9, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape, np.float32)
    for t0 in range(0, k.shape[-2], tile):
        s = q @ np.swapaxes(k[..., t0:t0 + tile, :], -1, -2)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        p = s - m_new
        l = l + p.sum(-1, keepdims=True)
        if round_p:
            p = torch.from_numpy(p).to(torch.bfloat16).float().numpy()
        acc = acc + p @ v[..., t0:t0 + tile, :]
        m = m_new
    return acc / np.maximum(l, 1.0)


def _qkv(seed=0, shape=(1, 2, 1024, 64)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_attention_control_plain_f32_matches_the_transcription():
    q, k, v = _qkv()
    got = ac.attention_control(*(torch.from_numpy(t) for t in (q, k, v)))
    want = _control_numpy(q, k, v, 512, round_p=False)
    # l <= 0 always, so the division is by 1 and outputs reach the
    # thousands: the bound is relative to the largest value.
    assert np.abs(want).max() > 100
    assert _rel(got.numpy(), want) < 1e-5


def test_attention_control_plain_bf16_matches_the_transcription():
    q, k, v = _qkv(seed=1)
    qt, kt, vt = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = ac.attention_control(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    want = _control_numpy(qt.float(), kt.float(), vt.float(), 512, round_p=True)
    assert _rel(got.float().numpy(), want) < 1e-2


def test_attention_control_depends_on_the_512_key_tiling():
    """Tiles of 256 keys move m between more tiles: a different answer, far
    beyond the 1e-5 the 512-key transcription agrees to."""
    q, k, v = _qkv(seed=2)
    got = ac.attention_control_plain(*(torch.from_numpy(t) for t in (q, k, v)))
    assert _rel(got.numpy(), _control_numpy(q, k, v, 512, round_p=False)) < 1e-5
    assert _rel(got.numpy(), _control_numpy(q, k, v, 256, round_p=False)) > 1e-2


# --- P4 / P5: slot writes ---------------------------------------------------


@pytest.mark.parametrize("rows,pos", [((448, 1280), 13), ((4, 448, 128), 1000),
                                      ((16, 64), 15)])
def test_write_row_plain_equals_dynamic_update_slice(rows, pos):
    rng = np.random.default_rng(pos)
    cache = rng.standard_normal(rows).astype(np.float32)
    row = rng.standard_normal((1, rows[-1])).astype(np.float32)
    cj, ct = _bf16(cache)
    rj, rt = _bf16(row)
    flat = cj.reshape(-1, rows[-1])
    want = jax.lax.dynamic_update_slice(flat, rj, (pos, 0)).reshape(rows)
    got = cw.write_row(ct, pos, rt)
    assert got.data_ptr() == ct.data_ptr()          # in place
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_write_row_loop_equals_dynamic_update_slice():
    """The TPU probe's 16 writes in a loop carry, slot i gets row i."""
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((16, 256)).astype(np.float32)
    rj, rt = _bf16(rows)
    cj = jax.lax.fori_loop(0, 16, lambda i, c: jax.lax.dynamic_update_slice(
        c, jax.lax.dynamic_slice(rj, (i, 0), (1, 256)), (i, 0)),
        jnp.zeros((64, 256), jnp.bfloat16))
    ct = torch.zeros(64, 256, dtype=torch.bfloat16)
    for i in range(16):
        cw.write_row(ct, i, rt[i])
    np.testing.assert_array_equal(ct.float().numpy(),
                                  np.asarray(cj.astype(jnp.float32)))


@pytest.mark.parametrize("shape,pos", [((8, 40, 228), 7), ((3, 5, 16), 0),
                                       ((3, 5, 16), 15)])
def test_write_column_plain_equals_dynamic_update_slice(shape, pos):
    """The assertion of tools/cache_write_probe.py:153-157, bit for bit."""
    rng = np.random.default_rng(pos + 1)
    cache = rng.standard_normal(shape).astype(np.float32)
    col = rng.standard_normal(shape[:2] + (1,)).astype(np.float32)
    cj, ct = _bf16(cache)
    colj, colt = _bf16(col)
    want = jax.lax.dynamic_update_slice(cj, colj, (0, 0, pos))
    got = cw.write_column(ct, colt, pos)
    assert got.data_ptr() == ct.data_ptr()
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _slot32(pos: int) -> torch.Tensor:
    return torch.tensor([pos], dtype=torch.int32)


@jax.jit
def _dus_row(flat, row, pos):
    """The TPU probe's write with a traced slot, passed as ``write_row_b``
    passes it (``tools/mega_caps_probe.py:78``)."""
    p = jnp.reshape(pos, (1,)).astype(jnp.int32)
    return jax.lax.dynamic_update_slice(flat, row, (p[0], 0))


@jax.jit
def _dus_column(cache, col, pos):
    """``pallas_write``'s slot, a (1,) int32 array (``tools/cache_write_probe.py:143``)."""
    p = jnp.reshape(pos, (1,)).astype(jnp.int32)
    return jax.lax.dynamic_update_slice(cache, col, (0, 0, p[0]))


@pytest.mark.parametrize("rows,pos", [((448, 1280), 13), ((4, 448, 128), 1000),
                                      ((16, 64), 15), ((16, 64), 0)])
def test_write_row_tensor_slot_equals_traced_dynamic_update_slice(rows, pos):
    rng = np.random.default_rng(pos + 2)
    cache = rng.standard_normal(rows).astype(np.float32)
    row = rng.standard_normal((1, rows[-1])).astype(np.float32)
    cj, ct = _bf16(cache)
    rj, rt = _bf16(row)
    want = _dus_row(cj.reshape(-1, rows[-1]), rj, jnp.int32(pos)).reshape(rows)
    got = cw.write_row(ct, _slot32(pos), rt)
    assert got.data_ptr() == ct.data_ptr()
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape,pos", [((8, 40, 228), 7), ((3, 8, 16), 0),
                                       ((3, 8, 16), 15), ((2, 16, 228), 227)])
def test_write_column_tensor_slot_equals_traced_dynamic_update_slice(shape, pos):
    rng = np.random.default_rng(pos + 3)
    cache = rng.standard_normal(shape).astype(np.float32)
    col = rng.standard_normal(shape[:2] + (1,)).astype(np.float32)
    cj, ct = _bf16(cache)
    colj, colt = _bf16(col)
    want = _dus_column(cj, colj, jnp.int32(pos))
    got = cw.write_column(ct, colt, _slot32(pos))
    assert got.data_ptr() == ct.data_ptr()
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_write_row_loop_on_a_tensor_index_equals_fori_loop():
    """The TPU probe's 16 writes in a ``fori_loop`` with the device loop
    index as the slot (``tools/mega_caps_probe.py:99-103``) against 16
    writes whose slot is element i of an int32 tensor."""
    rng = np.random.default_rng(8)
    rows = rng.standard_normal((16, 256)).astype(np.float32)
    rj, rt = _bf16(rows)

    @jax.jit
    def loop_writes(cache):
        def body(i, c):
            return _dus_row(c, jax.lax.dynamic_slice(rj, (i, 0), (1, 256)), i)
        return jax.lax.fori_loop(0, 16, body, cache)

    cj = loop_writes(jnp.zeros((64, 256), jnp.bfloat16))
    index = torch.arange(16, dtype=torch.int32).split(1)
    ct = torch.zeros(64, 256, dtype=torch.bfloat16)
    for i in range(16):
        cw.write_row(ct, index[i], rt[i])
    np.testing.assert_array_equal(ct.float().numpy(),
                                  np.asarray(cj.astype(jnp.float32)))


# --- the probe entry points -------------------------------------------------


@pytest.mark.parametrize("probe,args,keys", [
    (gemv_chain_probe, ["--hybrid"], ("err_chain_vs_plain", "layer_equals_chain")),
    (attention_probe, [], ("k2_max_abs_err_vs_library",
                           "control_err_vs_plain_rel_to_max")),
    (mega_caps_probe, [], ("row_write_ok", "loop16_ok")),
    (cache_write_probe, [], ("write_ok",)),
])
def test_probe_entry_point_runs_on_the_cpu(capsys, probe, args, keys):
    result = probe.main(["--device", "cpu", *args])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert line["device"] == "cpu" and line["card"] == "cpu"
    for key in keys:
        assert key in line
    assert not any(k.startswith(("ms", "us")) for k in line)   # no CPU times
