"""The schedule of P2/P3 (csrc/mlp_chain.cu), emulated in torch on the CPU:
no GPU needed.

The kernel streams the (L, out, in) int8 weights of ``pack_mlp_weights``:
each of its blocks owns the rows ``row_range`` gives it of W1[l] (F rows)
and of W2[l] (D rows), in 16-row tiles of 1280-column ring stages, and
runs the decode engine's product on them: warp w takes the 64-column
blocks w, w + 16, ... of each stage, each block summed from zero (its
columns in two halves, the mma steps 0, 2 and 1, 3) and added to the
warp's total, the 16 warps' totals added in warp order; scale and bias
after the sum.

- ``pack_mlp_weights`` gives the transposes, contiguous and int8.
- At f32 the emulation over the packed layout equals ``mlp_chain_plain``
  to 1e-5 of the largest value, at the probe's widths and at the card
  tests' small ones, for 132 and 114 blocks; every row is computed once.
- The emulation over [l, l + 1), layer after layer, equals it over
  [0, L) bit for bit (the kernel's P3 x L == P2).
- With the plain version's bf16 rounding points, leaving out the rounding
  of GELU's input or of y before the residual moves the output at least
  twice as far from the plain version as the kernel's own sum order does:
  the card test ``test_mlp_chain_kernel_rounds_as_plain`` holds the kernel
  to half that distance.
- For L = 32 at large-v3 widths and 132 or 114 blocks, the producer's walk
  opens as many ring stages a block as the consumers' walk acquires (a
  mismatch is a ring that never fills, which the kernel's 2 s wait turns
  into a trap), and the ring holds more than a layer's stages.
"""

import pytest
import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.ops import mega_step as tm
from thewhisper_tpu_torch.ops import mlp_chain as mc
from thewhisper_tpu_torch.tools.gemv_chain_probe import make_inputs, operands

TILE, STAGE, WARPS = 16, 1280, 16
# csrc/mega_common.cuh: a stage's bytes, the opt-in shared memory of an H100
# block, and the layout's fixed part at W = 1 (mbarriers, two product
# buffers, stats, wred, act of max(D, F) + 8 bf16), 128-byte aligned parts.
STAGE_BYTES = TILE * (STAGE + 64)
SMEM_LIMIT = 232448


def _case(n_layers, d, f, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    p = make_inputs(n_layers, d, f, g, torch.device("cpu"))
    return p["x"].to(dtype), operands(p)


def _rows(block, blocks, n):
    """The rows the kernel's tile walk gives ``block``: 16-row tiles of its
    row_range."""
    lo, hi = tm.row_range(block, blocks, n)
    return [r for m0 in range(lo, hi, TILE) for r in range(m0, min(m0 + TILE, hi))]


# The columns of a 64-column block in the first chain of mma steps (0, 2):
# step jj takes columns 16 t + 4 jj + {0, 1, 2, 3} for t = 0 .. 3.
_FIRST_CHAIN = torch.tensor([((c % 16) // 4) % 2 == 0 for c in range(64)])


def _product(wt: torch.Tensor, act: torch.Tensor, blocks: int) -> torch.Tensor:
    """sum_k act[k] wt[r, k] for every row, in the kernel's order, in f32
    (an mma's own additions in the order of torch's sum). The order is the
    same for every row, so rows go together; the tile walk only says which
    rows a block computes (each exactly once)."""
    n, k = wt.shape
    seen = torch.zeros(n, dtype=torch.int64)
    for b in range(blocks):
        seen[_rows(b, blocks, n)] += 1
    assert bool((seen == 1).all())
    warps = torch.zeros(n, WARPS)
    for k0 in range(0, k, STAGE):
        terms = (wt[:, k0:k0 + STAGE].float() * act[k0:k0 + STAGE]).reshape(n, -1, 64)
        block = (terms[..., _FIRST_CHAIN].sum(-1) + terms[..., ~_FIRST_CHAIN].sum(-1))
        for j in range(block.shape[1]):
            warps[:, j % WARPS] += block[:, j]
    total = torch.zeros(n)
    for w in range(WARPS):
        total += warps[:, w]
    return total


def _emulate(x, ops, packed, l0, l1, blocks, round_gelu=True, round_residual=True):
    """The kernel over layers [l0, l1) on the packed weights. x's dtype is
    the compute type: bf16 rounds where the plain version does (each one
    can be left out, as a faulty kernel would), f32 rounds nowhere."""
    ln_s, ln_b, s1, b1, s2, b2 = ops[:6]
    dt = x.dtype
    rnd = (lambda t: t.to(dt).float())
    xf = x.float()[0]
    for l in range(l0, l1):
        q = rnd(F.layer_norm(xf, xf.shape, ln_s[l], ln_b[l], 1e-5))
        y1 = _product(packed.w1t[l], q, blocks) * s1[l] + b1[l]
        h = rnd(F.gelu(rnd(y1) if round_gelu else y1, approximate="tanh"))
        y2 = _product(packed.w2t[l], h, blocks) * s2[l] + b2[l]
        xf = rnd(xf + (rnd(y2) if round_residual else y2))
    return xf[None].to(dt)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def test_pack_gives_the_contiguous_transposes():
    _, ops = _case(3, 256, 1024)
    w1, w2 = ops[6], ops[7]
    packed = mc.pack_mlp_weights(w1, w2)
    assert packed.w1t.shape == (3, 1024, 256) and packed.w2t.shape == (3, 256, 1024)
    for got, src in ((packed.w1t, w1), (packed.w2t, w2)):
        assert got.dtype == torch.int8 and got.is_contiguous()
        assert torch.equal(got, src.transpose(1, 2))
    assert packed.source == (w1.data_ptr(), w2.data_ptr())


@pytest.mark.parametrize("n_layers,d,f", [(2, 1280, 5120), (3, 256, 1024)])
@pytest.mark.parametrize("blocks", [132, 114])
def test_schedule_at_f32_equals_plain(n_layers, d, f, blocks):
    x, ops = _case(n_layers, d, f, seed=blocks)
    packed = mc.pack_mlp_weights(ops[6], ops[7])
    got = _emulate(x, ops, packed, 0, n_layers, blocks)
    assert _rel(got, mc.mlp_chain_plain(x, *ops)) <= 1e-5


def test_layer_by_layer_equals_the_chain_bit_for_bit():
    x, ops = _case(3, 256, 1024, seed=5, dtype=torch.bfloat16)
    packed = mc.pack_mlp_weights(ops[6], ops[7])
    chain = _emulate(x, ops, packed, 0, 3, 132)
    y = x
    for l in range(3):
        y = _emulate(y, ops, packed, l, l + 1, 132)
    assert torch.equal(y, chain)


@pytest.mark.parametrize("fault", ["round_gelu", "round_residual"])
def test_a_dropped_rounding_moves_the_output_past_the_card_bound(fault):
    """At L = 1 and the probe's widths (the card test's case): the
    kernel's order at bf16 against the plain version, and the same with
    one rounding left out."""
    x, ops = _case(1, 1280, 5120, seed=21, dtype=torch.bfloat16)
    packed = mc.pack_mlp_weights(ops[6], ops[7])
    plain = mc.mlp_chain_plain(x, *ops)
    own = _l2(_emulate(x, ops, packed, 0, 1, 132), plain)
    faulty = _l2(_emulate(x, ops, packed, 0, 1, 132, **{fault: False}), plain)
    assert own <= 0.5 * faulty, (own, faulty)


def _walk(blocks, block, n_layers, d, f, side):
    """Ring stages a block's producer opens (``side`` "producer": for each
    layer the tiles of W1[l], (F, D), then of W2[l], (D, F)) or its
    consumers acquire ("consumers": for each layer the fc1 product, R = F
    rows over K = D, then fc2's, R = D over K = F)."""
    def tiles(rows, cols):
        lo, hi = tm.row_range(block, blocks, rows)
        return sum(1 for _ in range(lo, hi, TILE) for _ in range(0, cols, STAGE))

    if side == "producer":
        mats = ((f, d), (d, f))            # pr.tiles(w1t, F, D), pr.tiles(w2t, D, F)
    else:
        mats = ((f, d), (d, f))            # gemm(R = F, K = D), gemm(R = D, K = F)
    return sum(tiles(r, k) for _ in range(n_layers) for r, k in mats)


def _fixed_smem(d, f):
    """layout(1, 1, max(D, F) + 8, 0, 0, 0).total of csrc/mega_common.cuh."""
    def up(n):
        return -(-n // 128) * 128

    red = 2 * 16 * 8
    stats = red + 4 * 2 * 16 * 16 * 8
    wred = stats + up(4 * (2 * 16 + 10))
    act = wred + up(4 * 16 * 16)
    attn = 4 * (2 * 16 + 64 + 0 + 4 * 512)
    return act + up(max(2 * (max(d, f) + 8), attn))


@pytest.mark.parametrize("blocks", [132, 114])
def test_producer_and_consumers_walk_the_same_stages(blocks):
    n_layers, d, f = 32, 1280, 5120
    stages = min(16, (SMEM_LIMIT - _fixed_smem(d, f)) // STAGE_BYTES)
    assert stages == 9
    for b in range(blocks):
        opened = _walk(blocks, b, n_layers, d, f, "producer")
        assert opened == _walk(blocks, b, n_layers, d, f, "consumers")
        per_layer = opened // n_layers
        assert per_layer == 7 and stages > per_layer     # 3 fc1 tiles + 4 fc2 stages

