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

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernel (not of the plain version) since import.
Q4_LAUNCHES = 0

ROWS = 16            # output rows of a block
BLOCK_K = 128        # input columns a warp takes at a time
MAX_WARPS = 8
BLOCKS_PER_SM = 4    # M-tiles are spread over grid.y up to this many blocks an SM

_sms: Dict[int, int] = {}


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


def plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int, int, int]:
    """Q4's launch for an (m, k) x against an (n, k) weight: (warps a
    block, NT, grid.x, grid.y). The warps split K in 128-column blocks, as
    many a warp (the most, up to 8, that divide K / 128); a block owns 16
    output rows and sweeps M-tiles of 8 NT rows (NT 1 up to 8 rows, else
    4), spread over grid.y up to ``BLOCKS_PER_SM`` blocks an SM. Raises
    ``ValueError`` for shapes the kernel does not take."""
    if n % ROWS or n <= 0:
        _fail(f"{n} output rows (takes a multiple of {ROWS})")
    if k % BLOCK_K or k <= 0:
        _fail(f"{k} input columns (takes a multiple of {BLOCK_K})")
    if m <= 0 or m >= 2 ** 31:
        _fail(f"{m} rows")
    kblocks = k // BLOCK_K
    warps = max(w for w in range(1, MAX_WARPS + 1) if kblocks % w == 0)
    nt = 1 if m <= 8 else 4
    mtiles = -(-m // (8 * nt))
    gx = n // ROWS
    gy = max(1, min(mtiles, -(-BLOCKS_PER_SM * sms // gx), 65535))
    return warps, nt, gx, gy


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
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q4: (..., in) x against the packed (out, in / 2) int4 weight with f32
    scales (out,) and an optional bias (out,) of x's type -> (..., out) in
    x's type. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise (``ValueError`` for what it does not take)."""
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
    warps, nt, _, gy = plan(m, n, k, _sm_count(index))
    code = _build.lib().twt_int4_linear(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k,
        int(x.dtype == torch.float32), warps, nt, gy, index,
        _build.stream_handle(x.device))
    _build.check(code, "twt_int4_linear")
    Q4_LAUNCHES += 1
    return y
