"""One slot of a bf16 KV cache written in place: the P4 and P5 kernels'
wrappers and their plain versions.

thewhisper_tpu's decode-step probes ask what writing one cache slot costs
against rewriting the whole cache: P4 (``tools/mega_caps_probe.py:74``
``write_row_b`` and ``:172`` ``write_row_big``) writes one (1, D) row of a
slot-major cache, P5 (``tools/cache_write_probe.py:127`` ``pallas_write``)
one column ``pos`` of a feature-major (R, F, T) cache. On the TPU both
carried workarounds (the 8-row group read-modify-write, the full-buffer
round trip through VMEM); here each is one launch of ``csrc/cache_write.cu``,
which writes the slot's elements and nothing else.

The slot is a Python ``int`` or, as the TPU kernels take it from SMEM, a
one-element int32 tensor on the cache's device. The kernel reads a tensor
slot when it runs, so a CUDA graph of a write replays it at whatever slot
the device holds then; a tensor slot outside the cache traps in the kernel
(a launch failure at the next synchronise, never a write outside it). Both
kernels are programmatic dependent launches: the next launch on the stream
may start while one runs, and each waits for its predecessor before it
touches memory.

Both update the cache in place and return it. CPU tensors take the plain
versions (a tensor slot read with ``int``); CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import operator
from typing import Dict, Optional, Tuple, Union

import torch

from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernels (not of the plain versions) since import: P4
# (a row) and P5 (a column).
ROW_LAUNCHES = 0
COLUMN_LAUNCHES = 0

Slot = Union[int, torch.Tensor]

# P5's blocks are one warp, so that they spread evenly over the SMs; an
# H100 SM holds 32 such blocks at once, and the grid fills the card at most
# once.
COLUMN_THREADS = 32
RESIDENT_BLOCKS_PER_SM = 32

_sms: Dict[int, int] = {}


def write_row_plain(cache: torch.Tensor, pos: Slot,
                    row: torch.Tensor) -> torch.Tensor:
    """``write_row`` in plain torch."""
    cache.view(-1, cache.shape[-1])[int(pos)] = row.reshape(-1)
    return cache


def write_column_plain(cache: torch.Tensor, col: torch.Tensor,
                       pos: Slot) -> torch.Tensor:
    """``write_column`` in plain torch."""
    cache[:, :, int(pos)] = col[:, :, 0]
    return cache


def _fail(what: str) -> None:
    raise ValueError(f"cache_write: {what}")


def check_slot(pos: Slot, limit: int,
               device: torch.device) -> Tuple[int, Optional[torch.Tensor]]:
    """(host slot, slot tensor): the slot as the kernel takes it, the
    tensor None for a host slot (and the host slot 0 for a tensor).

    A host slot must be an integer in [0, limit). A tensor slot must be a
    one-element int32 tensor on ``device``; on a CUDA device the kernel
    checks its range, on the CPU this does (the host can read it)."""
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1:
            _fail(f"slot tensor of dtype {pos.dtype} and {pos.numel()} elements "
                  f"(takes one int32)")
        if pos.device != device:
            _fail(f"slot tensor on {pos.device}, cache on {device}")
        if device.type == "cpu" and not 0 <= int(pos) < limit:
            _fail(f"slot {int(pos)} outside the cache's {limit}")
        return 0, pos
    if isinstance(pos, bool):
        _fail("slot must be an integer")
    pos = operator.index(pos)
    if not 0 <= pos < limit:
        _fail(f"slot {pos} outside the cache's {limit}")
    return pos, None


def row_plan(cache: torch.Tensor, row: torch.Tensor) -> Tuple[int, int, int]:
    """P4's launch, (rows, blocks, threads): one block of D / 8 threads,
    thread c copying the row's 16-byte chunk c. Raises ``ValueError`` for
    what the kernel does not take: a width that is not a multiple of 8 or
    above 8192, a cache or row that is not contiguous bf16 or not 16-byte
    aligned."""
    d = cache.shape[-1]
    if cache.dtype != torch.bfloat16 or row.dtype != torch.bfloat16:
        _fail("cache and row must be bf16")
    if not (cache.is_contiguous() and row.is_contiguous()):
        _fail("contiguous operands")
    if row.numel() != d:
        _fail(f"row of {row.numel()} elements for width {d}")
    if d % 8 or not 0 < d <= 8192:
        _fail(f"width {d} (takes a multiple of 8 up to 8192: 16-byte chunks)")
    if (cache.data_ptr() | row.data_ptr()) % 16:
        _fail("cache and row must be 16-byte aligned")
    rows = cache.numel() // d
    if rows >= 2 ** 31:
        _fail(f"{rows} rows (takes fewer than 2^31)")
    return rows, 1, d // 8


def column_plan(cache: torch.Tensor, col: torch.Tensor,
                sms: int) -> Tuple[int, int, int]:
    """P5's launch, (groups, blocks, threads): a group is 8 consecutive
    column values, one 16-byte load; ``COLUMN_THREADS`` threads a block, as
    many blocks as the groups need up to what ``sms`` SMs hold at once, a
    grid-stride loop beyond. Raises ``ValueError`` for what the kernel does
    not take: R F not a multiple of 8, a cache of 2^31 elements or more, an
    operand that is not contiguous bf16, a column not 16-byte aligned."""
    if cache.ndim != 3:
        _fail(f"cache of shape {tuple(cache.shape)} (takes (R, F, T))")
    r, f, _ = cache.shape
    if col.shape != (r, f, 1):
        _fail(f"column of shape {tuple(col.shape)}")
    if cache.dtype != torch.bfloat16 or col.dtype != torch.bfloat16:
        _fail("cache and column must be bf16")
    if not (cache.is_contiguous() and col.is_contiguous()):
        _fail("contiguous operands")
    if r * f % 8:
        _fail(f"R F = {r * f} (takes a multiple of 8)")
    if cache.numel() >= 2 ** 31:
        _fail(f"cache of {cache.numel()} elements (takes fewer than 2^31: 32-bit offsets)")
    if col.data_ptr() % 16:
        _fail("column must be 16-byte aligned")
    groups = r * f // 8
    blocks = min(-(-groups // COLUMN_THREADS), sms * RESIDENT_BLOCKS_PER_SM)
    return groups, blocks, COLUMN_THREADS


def _sm_count(index: int) -> int:
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _cuda_args(device: torch.device, src: torch.Tensor) -> Tuple[int, int]:
    if device.type != "cuda":
        _fail(f"unsupported device {device}")
    if src.device != device:
        _fail("cache and source must share one device")
    return device.index or 0, _build.stream_handle(device)


def write_row(cache: torch.Tensor, pos: Slot, row: torch.Tensor) -> torch.Tensor:
    """P4: row ``pos`` of the (rows, D) view of a slot-major (..., S, D)
    bf16 cache = ``row`` ((D,) or (1, D)); ``pos`` counts rows over the
    leading dimensions too (slot s of layer l is row l S + s), a Python int
    or a one-element int32 tensor on the cache's device. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    global ROW_LAUNCHES
    d, device = cache.shape[-1], cache.device
    host, slot = check_slot(pos, cache.numel() // d, device)
    if device.type == "cpu":
        if row.numel() != d:
            _fail(f"row of {row.numel()} elements for width {d}")
        return write_row_plain(cache, pos, row)
    rows, _, threads = row_plan(cache, row)
    index, stream = _cuda_args(device, row)
    code = _build.lib().twt_write_row(
        cache.data_ptr(), row.data_ptr(), None if slot is None else slot.data_ptr(),
        host, rows, threads, index, stream)
    _build.check(code, "twt_write_row")
    ROW_LAUNCHES += 1
    return cache


def write_column(cache: torch.Tensor, col: torch.Tensor, pos: Slot) -> torch.Tensor:
    """P5: ``cache[:, :, pos] = col[:, :, 0]`` on an (R, F, T) bf16 cache
    with ``col`` (R, F, 1); ``pos`` a Python int or a one-element int32
    tensor on the cache's device. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    global COLUMN_LAUNCHES
    if cache.ndim != 3:
        _fail(f"cache of shape {tuple(cache.shape)} (takes (R, F, T))")
    device = cache.device
    host, slot = check_slot(pos, cache.shape[2], device)
    if device.type == "cpu":
        return write_column_plain(cache, col, pos)
    index, stream = _cuda_args(device, col)
    groups, blocks, threads = column_plan(cache, col, _sm_count(index))
    code = _build.lib().twt_write_column(
        cache.data_ptr(), col.data_ptr(), None if slot is None else slot.data_ptr(),
        host, cache.shape[2], groups, blocks, threads, index, stream)
    _build.check(code, "twt_write_column")
    COLUMN_LAUNCHES += 1
    return cache


def empty_launch(device: torch.device, pdl: bool) -> None:
    """One launch of an empty kernel (one warp) on ``device``'s current
    stream, with or without programmatic dependent launch: what a launch
    costs alone, the floor P4 and P5 are measured against. No path of the
    port calls it."""
    code = _build.lib().twt_empty_launch(int(pdl), device.index or 0,
                                         _build.stream_handle(device))
    _build.check(code, "twt_empty_launch")
