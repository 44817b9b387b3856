"""P4's and P5's launch plans and host-side refusals on the CPU (no card).

The wrappers of ``csrc/cache_write.cu`` size every launch from two pure
functions of the shapes: ``row_plan`` (P4: one block of D / 8 threads, thread
c copying the row's 16-byte chunk c) and ``column_plan`` (P5: thread x of
block b takes the groups b n + x, b n + x + blocks n, ... of 8 consecutive
column values, n threads a block). The tests emulate those schedules in numpy
as the kernels run them and show that every element of the slot is written
exactly once and nothing outside it, over the five Whisper widths, the
probes' shapes and ragged small ones (P5 also on grids of one and two SMs,
where the grid-stride loop turns). The refusals a CUDA call meets on the host
(width, alignment, size, the slot tensor's dtype, shape and device, a host
slot's range) are reached here through the same functions, and each C entry
point's parameters are held against the ``ctypes`` signature ``_build``
declares for it.
"""

import re

import numpy as np
import pytest
import torch

from thewhisper_tpu_torch.ops import _build
from thewhisper_tpu_torch.ops import cache_write as cw

from _torch_tiny import one_cpu_thread  # noqa: F401

WHISPER_WIDTHS = (384, 512, 768, 1024, 1280)


def _row_writes(rows: int, d: int, slot: int, threads: int) -> np.ndarray:
    """How often the P4 schedule writes each element of a (rows, d) cache:
    thread c of the one block stores the 8 elements of chunk c of row
    ``slot``."""
    count = np.zeros(rows * d, np.int64)
    base = slot * d
    for c in range(threads):
        count[base + 8 * c: base + 8 * c + 8] += 1
    return count.reshape(rows, d)


@pytest.mark.parametrize("shape,slot", [
    *[((448, d), 447) for d in WHISPER_WIDTHS],
    *[((2, 448, d), 448 + 13) for d in WHISPER_WIDTHS],
    ((32 * 448, 1280), 14335), ((32, 448, 1280), 0),
    ((1, 8), 0), ((3, 16), 2), ((5, 24), 1), ((7, 40), 6), ((2, 3, 136), 5)])
def test_row_plan_writes_the_slot_once_and_nothing_else(shape, slot):
    cache = torch.empty(shape, dtype=torch.bfloat16)
    row = torch.empty(shape[-1], dtype=torch.bfloat16)
    rows, blocks, threads = cw.row_plan(cache, row)
    d = shape[-1]
    assert (rows, blocks, threads) == (cache.numel() // d, 1, d // 8)
    count = _row_writes(rows, d, slot, threads)
    assert (count[slot] == 1).all()
    assert count.sum() == d                      # nothing outside the slot


def _column_writes(r: int, f: int, t: int, slot: int, groups: int, blocks: int,
                   threads: int) -> np.ndarray:
    """How often the P5 schedule writes each element of an (r, f, t) cache:
    the grid-stride loop of every thread over the groups, each group's 8
    values stored at (8 g + k) t + slot."""
    count = np.zeros(r * f * t, np.int64)
    for b in range(blocks):
        for x in range(threads):
            g = np.arange(b * threads + x, groups, blocks * threads)
            for k in range(8):
                np.add.at(count, (8 * g + k) * t + slot, 1)
    return count.reshape(r * f, t)


@pytest.mark.parametrize("shape,slot,sms", [
    ((128, 1280, 228), 7, 132), ((128, 1280, 228), 227, 132), ((128, 1280, 256), 7, 132),
    *[((4, 20 * 64 if d == 1280 else d, 7), 3, 132) for d in WHISPER_WIDTHS],
    ((128, 1280, 228), 0, 1), ((128, 1280, 228), 100, 2),
    ((1, 8, 1), 0, 132), ((3, 8, 5), 4, 1), ((2, 40, 17), 16, 132), ((5, 24, 3), 1, 1),
    ((6, 1000, 2), 1, 1)])
def test_column_plan_writes_the_slot_once_and_nothing_else(shape, slot, sms):
    r, f, t = shape
    cache = torch.empty(shape, dtype=torch.bfloat16)
    col = torch.empty(r, f, 1, dtype=torch.bfloat16)
    groups, blocks, threads = cw.column_plan(cache, col, sms)
    assert groups * 8 == r * f and threads == cw.COLUMN_THREADS
    # The grid fills the card at most once, and needs no more blocks than
    # the groups do.
    assert blocks <= sms * cw.RESIDENT_BLOCKS_PER_SM
    assert (blocks - 1) * threads < groups
    count = _column_writes(r, f, t, slot, groups, blocks, threads)
    assert (count[:, slot] == 1).all()
    assert count.sum() == r * f                  # nothing outside the slot


def test_column_plan_fills_the_card_once_at_the_probe_shape():
    """The probe's (128, 1280, 228): 20,480 groups, 640 blocks of one warp,
    all resident on an H100's 132 SMs at once."""
    cache = torch.empty(128, 1280, 228, dtype=torch.bfloat16)
    col = torch.empty(128, 1280, 1, dtype=torch.bfloat16)
    assert cw.column_plan(cache, col, 132) == (20480, 640, 32)


def test_row_plan_refusals():
    with pytest.raises(ValueError, match="multiple of 8"):
        cw.row_plan(torch.empty(4, 100, dtype=torch.bfloat16),
                    torch.empty(100, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 8"):
        cw.row_plan(torch.empty(2, 8200, dtype=torch.bfloat16),
                    torch.empty(8200, dtype=torch.bfloat16))
    cache = torch.empty(4, 256, dtype=torch.bfloat16)
    buf = torch.empty(600, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="aligned"):
        cw.row_plan(cache, buf[1:257])
    with pytest.raises(ValueError, match="aligned"):
        cw.row_plan(buf[4:4 + 512].view(2, 256), buf[:256])
    with pytest.raises(ValueError, match="bf16"):
        cw.row_plan(cache, torch.empty(256))
    with pytest.raises(ValueError, match="contiguous"):
        cw.row_plan(torch.empty(256, 4, dtype=torch.bfloat16).t(),
                    torch.empty(256, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="elements for width"):
        cw.row_plan(cache, torch.empty(128, dtype=torch.bfloat16))


def test_column_plan_refusals():
    with pytest.raises(ValueError, match="multiple of 8"):
        cw.column_plan(torch.empty(1, 4, 16, dtype=torch.bfloat16),
                       torch.empty(1, 4, 1, dtype=torch.bfloat16), 132)
    with pytest.raises(ValueError, match="2\\^31"):
        cw.column_plan(torch.empty(8, 2 ** 25, 8, dtype=torch.bfloat16, device="meta"),
                       torch.empty(8, 2 ** 25, 1, dtype=torch.bfloat16, device="meta"), 132)
    buf = torch.empty(2 * 64 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        cw.column_plan(torch.empty(2, 64, 3, dtype=torch.bfloat16),
                       buf[1:1 + 128].view(2, 64, 1), 132)
    with pytest.raises(ValueError, match="column of shape"):
        cw.column_plan(torch.empty(2, 64, 3, dtype=torch.bfloat16),
                       torch.empty(2, 64, 2, dtype=torch.bfloat16), 132)
    with pytest.raises(ValueError, match="takes \\(R, F, T\\)"):
        cw.column_plan(torch.empty(2, 64, dtype=torch.bfloat16),
                       torch.empty(2, 64, 1, dtype=torch.bfloat16), 132)


@pytest.mark.parametrize("bad,match", [
    (torch.tensor([3]), "slot tensor of dtype torch.int64"),
    (torch.tensor([3, 4], dtype=torch.int32), "2 elements"),
    (torch.tensor([3], dtype=torch.int32, device="meta"), "slot tensor on meta"),
    (torch.tensor([16], dtype=torch.int32), "outside"),
    (torch.tensor([-1], dtype=torch.int32), "outside"),
    (16, "outside"), (-1, "outside"), (True, "integer"), (2.0, None)])
def test_check_slot_refusals(bad, match):
    with pytest.raises((ValueError, TypeError), match=match):
        cw.check_slot(bad, 16, torch.device("cpu"))


def test_check_slot_forms():
    cpu = torch.device("cpu")
    assert cw.check_slot(15, 16, cpu) == (15, None)
    assert cw.check_slot(np.int64(3), 16, cpu) == (3, None)
    slot = torch.tensor([7], dtype=torch.int32)
    host, tensor = cw.check_slot(slot, 16, cpu)
    assert host == 0 and tensor is slot
    # On a CUDA device the kernel checks a tensor slot's range: the host
    # does not read it (a meta tensor stands for one the host cannot read).
    meta = torch.tensor([99], dtype=torch.int32, device="meta")
    assert cw.check_slot(meta, 16, torch.device("meta"))[1] is meta


@pytest.mark.parametrize("kind", ["int", "tensor"])
def test_cpu_writes_take_both_slot_forms(kind):
    g = torch.Generator().manual_seed(3)
    cache = torch.randn(2, 8, 16, generator=g).to(torch.bfloat16)
    row = torch.randn(16, generator=g).to(torch.bfloat16)
    col = torch.randn(2, 8, 1, generator=g).to(torch.bfloat16)
    pos = 11 if kind == "int" else torch.tensor([11], dtype=torch.int32)
    want = cache.clone()
    want.view(-1, 16)[11] = row
    got = cw.write_row(cache.clone(), pos, row)
    assert torch.equal(got, want)
    want = cache.clone()
    want[:, :, 11] = col[:, :, 0]
    assert torch.equal(cw.write_column(cache.clone(), col, pos), want)
    assert torch.equal(cw.write_column_plain(cache.clone(), col, pos), want)


def _c_type(param: str):
    if "*" in param:
        return _build._P
    kind = param.rsplit(" ", 1)[0].strip()
    return {"int": _build._I, "long long": _build._L}[kind]


def test_every_c_entry_point_matches_its_ctypes_signature():
    """ctypes passes what ``_SIGNATURES`` says: a parameter miscounted
    there shifts every later argument (or, short, raises at the call)."""
    found = {}
    for src in _build._sources():
        for name, params in re.findall(r'extern "C" int (twt_\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = [_c_type(p.strip()) for p in params.split(",")]
    assert found.keys() == _build._SIGNATURES.keys()
    for name, argtypes in found.items():
        assert argtypes == _build._SIGNATURES[name], name
