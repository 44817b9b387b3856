"""Q4, the int4 weight-only linear of the "S4" decoder: the kernel's wrapper
(``csrc/int4_linear.cu``), its plain version and the packed layout.

The JAX package stores an S4 weight as a ``jnp.int4`` leaf and dequantizes
it inside an XLA fusion (``thewhisper_tpu/models/whisper.py:110-123``); no
Pallas kernel runs it. Here the weight is a ``uint8`` (out, in / 2) buffer
of two's-complement nibbles, input index 2j in the low nibble of byte j and
2j + 1 in the high one, and Q4 multiplies over it directly.

The rounding is JAX's: each weight is ``q.to(dtype) * scale.to(dtype)``,
rounded to the compute type, the product summed in f32 and rounded to it,
then the bias added in it. CPU tensors take the plain version; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernel (not of the plain version) since import.
Q4_LAUNCHES = 0

ROWS = 16            # output rows of a decode (and f32) block
BLOCK_K = 128        # input columns a warp takes at a time
MAX_WARPS = 8        # warps of an f32 block, and of a decode block but
DECODE_WARPS = 16    # where a warp holds 8-row M-tiles and at most 2 k-blocks
MAX_KPW = 4          # k-blocks a decode warp holds in registers
MAX_SPLIT = 8        # blocks of a decode split-K cluster
TILE = 128           # output rows of a tiled block, and its x rows past 256
TILED_WARPS = 9      # two consumer warpgroups and a producer warp
BLOCKS_PER_SM = 4    # the f32 route's M-tiles are spread over grid.y up to this
# The most rows the decode route takes; more go to the tiled route.
DECODE_MAX_ROWS = 32
# Launch with programmatic dependent launch where the plan does (False:
# never, for measurements).
PDL = True

ROUTES = ("f32", "decode", "tiled")  # the C entry point's route numbers

_sms: Dict[int, int] = {}


class Plan(NamedTuple):
    """One Q4 launch: ``route`` "decode", "tiled" or "f32"; ``warps`` a
    block; x rows a tile 8 ``nt`` (M-tiles of the decode and f32 routes,
    the tiled route's tiles); ``kpw`` k-blocks a decode warp holds;
    ``split`` blocks of a split-K cluster (decode, tiled); ``grid`` (x, y);
    ``pdl``: a programmatic dependent launch."""
    route: str
    warps: int
    nt: int
    kpw: int
    split: int
    grid: Tuple[int, int]
    pdl: bool = False


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., in) integers in [-8, 7] -> (..., in / 2) ``uint8``: input index
    2j in the low nibble of byte j, 2j + 1 in the high one, two's
    complement. ``in`` must be even, as every Whisper width is."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4: odd input width {q.shape[-1]}")
    u = q.to(torch.int16) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: (..., in / 2) ``uint8`` ->
    (..., in) ``int8`` in [-8, 7]."""
    p = packed.to(torch.int16)
    q = torch.stack([p & 0xF, p >> 4], dim=-1).flatten(-2)
    return ((q ^ 8) - 8).to(torch.int8)


def int4_linear_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`int4_linear` in plain torch: the whole weight dequantized in
    x's type, then ``F.linear`` and the bias."""
    w = unpack_int4(packed).to(x.dtype) * scale.to(x.dtype)[:, None]
    y = F.linear(x, w)
    return y if bias is None else y + bias.to(y.dtype)


def _fail(what: str) -> None:
    raise ValueError(f"int4_linear: {what}")


def plan(m: int, n: int, k: int, sms: int, f32: bool = False) -> Plan:
    """Q4's launch for an (m, k) x against an (n, k) weight on a card of
    ``sms`` SMs. Raises ``ValueError`` for shapes the kernel does not take.

    bf16, the decode route: a block owns 16 output rows; a cluster of
    ``split`` blocks (1, 2, 4 or 8) splits the K / 128 k-blocks until a
    block has at most 10 (block ``rank`` takes ``rank * kb // split`` up to
    ``(rank + 1) * kb // split``), and the block's warps split its share,
    every k-block held in registers from the kernel's start. Up to 8 rows
    (M-tiles of 8): one k-block a warp. From 9 to ``DECODE_MAX_ROWS``
    (M-tiles of 32): two k-blocks a warp where the blocks fit one an SM,
    else three, and only where they fit two an SM; else the tiled route.

    bf16 otherwise, or where a decode warp would hold more than 4
    k-blocks: the tiled route, tiles of 128 output rows by 32 x rows (m up
    to 256) or 128, and, with 32-row tiles, clusters of 4 blocks that split
    K's stages where the tiles leave most SMs idle (20 tiles or fewer) or
    K is long (32 stages or more, fc2's 5120).

    The crossover, on the H100 (132 SMs) at large-v3's six linears: up to
    8 rows the decode route takes 2.5-5.3 us a launch against the tiled
    route's 6.7-12.1; at 16 and 32 rows it wins where its blocks fit two an
    SM (qkv 3840 x 1280 and the 1280 x 1280 three) and loses at fc1 and fc2;
    at 64 rows the tiled route wins every shape (``tools/q4_probe.py
    --explore``, PERF.md §6).

    PDL: the decode route and the 128-row tiles launch with it, the
    32-row tiles without (``tools/q4_probe.py --sweep`` on the H100, a
    layer's six: 0.0208 ms with it against 0.0287 without at M = 1, 0.1955
    against 0.2003 at M = 1500; 32-row tiles at M = 32 as fast or faster
    without it).

    f32: warps dividing K / 128 (the most up to 8), 16 output rows a block
    sweeping M-tiles of 8 NT rows (NT 1 up to 8 rows, else 4), spread over
    grid.y up to ``BLOCKS_PER_SM`` blocks an SM; no PDL."""
    if n % ROWS or n <= 0:
        _fail(f"{n} output rows (takes a multiple of {ROWS})")
    if k % BLOCK_K or k <= 0:
        _fail(f"{k} input columns (takes a multiple of {BLOCK_K})")
    if m <= 0 or m >= 2 ** 31:
        _fail(f"{m} rows")
    kblocks, groups = k // BLOCK_K, n // ROWS
    nt = 1 if m <= 8 else 4
    if f32:
        warps = max(w for w in range(1, MAX_WARPS + 1) if kblocks % w == 0)
        mtiles = -(-m // (8 * nt))
        gy = max(1, min(mtiles, -(-BLOCKS_PER_SM * sms // groups), 65535))
        return Plan("f32", warps, nt, 0, 1, (groups, gy))
    split = 1
    while split < MAX_SPLIT and -(-kblocks // split) > 10 and 2 * split <= kblocks:
        split *= 2
    blocks = groups * split
    if m <= DECODE_MAX_ROWS and groups <= 65535 and (nt == 1 or blocks <= 2 * sms):
        per = -(-kblocks // split)
        kpw = 1 if nt == 1 else 2 if blocks <= sms else 3
        while kpw <= MAX_KPW and -(-per // kpw) > (
                DECODE_WARPS if nt == 1 and kpw <= 2 else MAX_WARPS):
            kpw += 1
        if kpw <= MAX_KPW:
            return Plan("decode", -(-per // kpw), nt, kpw, split, (split, groups), True)
    bn = 32 if m <= 256 else TILE
    tiles, stages, gy = -(-n // TILE), k // BLOCK_K, -(-m // bn)
    if gy > 65535:
        _fail(f"{m} rows (the tiled route takes at most {65535 * bn})")
    split = 4 if bn == 32 and stages >= 8 and (tiles * gy <= 20 or stages >= 32) else 1
    return Plan("tiled", TILED_WARPS, bn // 8, 0, split, (split * tiles, gy), bn == TILE)


def _sm_count(index: int) -> int:
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _check(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor]) -> None:
    k = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        _fail(f"x of dtype {x.dtype} (takes bf16 or f32)")
    if packed.dtype != torch.uint8 or packed.ndim != 2 or packed.shape[1] * 2 != k:
        _fail(f"weight {packed.dtype} {tuple(packed.shape)} for {k} inputs "
              "(takes uint8 (out, in / 2))")
    n = packed.shape[0]
    if scale.dtype != torch.float32 or scale.shape != (n,):
        _fail(f"scale {scale.dtype} {tuple(scale.shape)} (takes f32 ({n},))")
    if bias is not None and (bias.dtype != x.dtype or bias.shape != (n,)):
        _fail(f"bias {bias.dtype} {tuple(bias.shape)} (takes {x.dtype} ({n},))")
    operands = (x, packed, scale) + (() if bias is None else (bias,))
    if any(t.device != x.device for t in operands):
        _fail("operands on more than one device")
    if not all(t.is_contiguous() for t in operands):
        _fail("contiguous operands")
    if (x.data_ptr() | packed.data_ptr()) % 16:
        _fail("x and the weight must be 16-byte aligned")


def int4_linear(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                launch: Optional[Plan] = None) -> torch.Tensor:
    """Q4: (..., in) x against the packed (out, in / 2) int4 weight with f32
    scales (out,) and an optional bias (out,) of x's type -> (..., out) in
    x's type. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise (``ValueError`` for what it does not take). ``launch``
    replaces :func:`plan`'s launch (for measurements; the C entry point
    refuses a plan its kernels do not take)."""
    global Q4_LAUNCHES
    if x.device.type == "cpu":
        return int4_linear_plain(x, packed, scale, bias)
    if x.device.type != "cuda":
        _fail(f"unsupported device {x.device}")
    _check(x, packed, scale, bias)
    n, k = packed.shape[0], x.shape[-1]
    m = x.numel() // k
    y = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    index = x.device.index or 0
    p = launch or plan(m, n, k, _sm_count(index), x.dtype == torch.float32)
    code = _build.lib().twt_int4_linear(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k,
        ROUTES.index(p.route), p.warps, p.nt, p.kpw, p.split, p.grid[1],
        int(PDL and p.pdl), index, _build.stream_handle(x.device))
    _build.check(code, "twt_int4_linear")
    Q4_LAUNCHES += 1
    return y
