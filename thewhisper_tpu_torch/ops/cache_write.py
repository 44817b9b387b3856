"""One slot of a bf16 KV cache written in place: the P4 and P5 kernels'
wrappers and their plain versions.

thewhisper_tpu's decode-step probes ask what writing one cache slot costs
against rewriting the whole cache: P4 (``tools/mega_caps_probe.py:74``
``write_row_b`` and ``:172`` ``write_row_big``) writes one (1, D) row of a
slot-major cache, P5 (``tools/cache_write_probe.py:127`` ``pallas_write``)
one column ``pos`` of a feature-major (R, F, T) cache. On the TPU both
carried workarounds (the 8-row group read-modify-write, the full-buffer
round trip through VMEM); here both are one launch of
``csrc/cache_write.cu``, which writes the slot's elements and nothing else.

Both update the cache in place and return it. CPU tensors take the plain
versions.
"""

from __future__ import annotations

import torch

from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernel (not of the plain versions) since import: P4
# (a row) and P5 (a column).
ROW_LAUNCHES = 0
COLUMN_LAUNCHES = 0


def write_row_plain(cache: torch.Tensor, pos: int,
                    row: torch.Tensor) -> torch.Tensor:
    """``write_row`` in plain torch."""
    cache.view(-1, cache.shape[-1])[pos] = row.reshape(-1)
    return cache


def write_column_plain(cache: torch.Tensor, col: torch.Tensor,
                       pos: int) -> torch.Tensor:
    """``write_column`` in plain torch."""
    cache[:, :, pos] = col[:, :, 0]
    return cache


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"cache_write: {what}")


def _strided_write(cache: torch.Tensor, src: torch.Tensor, base: int,
                   stride: int) -> None:
    _check(cache.device.type == "cuda", f"unsupported device {cache.device}")
    _check(cache.dtype == src.dtype == torch.bfloat16, "cache and slot must be bf16")
    _check(cache.device == src.device, "cache and slot must share one device")
    _check(cache.is_contiguous() and src.is_contiguous(), "contiguous operands")
    code = _build.lib().twt_strided_write(
        cache.data_ptr(), src.data_ptr(), src.numel(), base, stride,
        cache.device.index or 0, _build.stream_handle(cache.device))
    _build.check(code, "twt_strided_write")


def write_row(cache: torch.Tensor, pos: int, row: torch.Tensor) -> torch.Tensor:
    """P4: row ``pos`` of the (rows, D) view of a slot-major (..., S, D)
    bf16 cache = ``row`` ((D,) or (1, D)); ``pos`` counts rows over the
    leading dimensions too (slot s of layer l is row l S + s). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    global ROW_LAUNCHES
    if cache.device.type == "cpu":
        return write_row_plain(cache, pos, row)
    d = cache.shape[-1]
    rows = cache.numel() // d
    _check(row.numel() == d, f"row of {row.numel()} elements for width {d}")
    _check(0 <= pos < rows, f"row {pos} outside the cache's {rows} rows")
    _strided_write(cache, row, int(pos) * d, 1)
    ROW_LAUNCHES += 1
    return cache


def write_column(cache: torch.Tensor, col: torch.Tensor, pos: int) -> torch.Tensor:
    """P5: ``cache[:, :, pos] = col[:, :, 0]`` on an (R, F, T) bf16 cache
    with ``col`` (R, F, 1). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global COLUMN_LAUNCHES
    if cache.device.type == "cpu":
        return write_column_plain(cache, col, pos)
    _check(cache.ndim == 3, f"cache of shape {tuple(cache.shape)} (takes (R, F, T))")
    r, f, t = cache.shape
    _check(col.shape == (r, f, 1), f"column of shape {tuple(col.shape)}")
    _check(0 <= pos < t, f"slot {pos} outside the cache's {t} slots")
    _strided_write(cache, col, int(pos), t)
    COLUMN_LAUNCHES += 1
    return cache
