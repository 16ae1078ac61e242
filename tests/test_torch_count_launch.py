"""K15's launch path (ops/exchange.py) on the CPU: the hand-over of its
arguments to the C entry point exchange_count of csrc/exchange.cu, looked
up in the kernel library once and called through ctypes against the
argtypes of kernels._SIGNATURES.

The kernel library needs nvcc, so here a stub of the entry point stands in
for it and records the arguments each call receives (the shard's block
read from the host array it is handed), and the current stream is a fixed
number.  A shard's count reaches it with the cells' pointer and n as a
64-bit int, the block, N, the box table with its rows and offsets, the
map's pointer (null in boxes mode), H, the outputs, the coordinate form
and the stream, in the C prototype's order.  The kernel splits a local cell
in 32 bits where the shard holds fewer than 2^31 cells and in 64 from
there; it wraps a box by one compare, so a block that leaves the grid is
refused, and it holds its box tables in a block's shared memory, so boxes
neither of whose tables fits COUNT_TABLE_INTS are refused, both before any
call.
"""

import ctypes
import os
import re
import subprocess

import pytest
import torch

from pinocchio_tpu_torch import kernels
from pinocchio_tpu_torch.ops import exchange as xops

STUB = r"""
#include <stdint.h>
int64_t seen[13];
int block[6];
int calls;
#define P(x) ((int64_t)(intptr_t)(x))
int exchange_count(const void* cells, int64_t n, const void* block_host,
                   int N, const void* boxes, int nb, const void* box_off,
                   const void* map, int H, void* bits, void* counts,
                   int wide, void* st) {
  int64_t v[] = {P(cells), n, 0, N, P(boxes), nb, P(box_off), P(map), H,
                 P(bits), P(counts), wide, P(st)};
  for (int i = 0; i < 13; ++i) seen[i] = v[i];
  for (int i = 0; i < 6; ++i) block[i] = ((const int*)block_host)[i];
  ++calls;
  return 0;
}
"""

STREAM = (1 << 43) + 40
N = 16
BLOCK = (8, 8, 8, 8, 0, 16)        # the (1, 1) shard of a 2x2 pencil


class Lookups:
    """Counts the kernel library's attribute lookups."""

    def __init__(self, lib):
        self.lib, self.names = lib, []

    def __getattr__(self, name):
        self.names.append(name)
        return getattr(self.lib, name)


@pytest.fixture
def stub(tmp_path, monkeypatch):
    src, so = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(STUB)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True)
    lib = kernels.bind(ctypes.CDLL(str(so)), ("exchange_count",))
    looked = Lookups(lib)
    monkeypatch.setattr(kernels, "lib", lambda: looked)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: STREAM)
    monkeypatch.setattr(xops, "_COUNT", None)
    return lib, looked


def _seen(lib):
    return (list((ctypes.c_int64 * 13).in_dll(lib, "seen")),
            tuple((ctypes.c_int * 6).in_dll(lib, "block")),
            ctypes.c_int.in_dll(lib, "calls").value)


def _case(nhosts, n=1000, block=BLOCK, map_=False):
    """Cells, a box table of one box a host (the last none) and outputs of
    a count's shapes; with map_ the hosts' request maps."""
    x0, nx, y0, ny, z0, nz = block
    cells = torch.arange(n, dtype=torch.int64) * 3
    rows = [[h % N, N // 2, 0, N + 3, N - 1, 4] for h in range(nhosts - 1)]
    boxes = torch.tensor(rows, dtype=torch.int32).reshape(-1, 6)
    off = torch.tensor(list(range(nhosts)) + [nhosts - 1], dtype=torch.int32)
    hmap = (torch.zeros((nhosts, nx, ny, nz), dtype=torch.uint8) if map_
            else None)
    bits = torch.empty((n, xops.words(nhosts)), dtype=torch.int32)
    counts = torch.empty((-(-n // xops.THREADS), nhosts), dtype=torch.int32)
    return cells, boxes, off, hmap, bits, counts


def _want(case, nhosts):
    cells, boxes, off, hmap, bits, counts = case
    return [cells.data_ptr(), cells.numel(), 0, N, boxes.data_ptr(),
            boxes.shape[0], off.data_ptr(),
            0 if hmap is None else hmap.data_ptr(), nhosts, bits.data_ptr(),
            counts.data_ptr(), 0, STREAM]


@pytest.mark.parametrize("nhosts", [2, 1, 16, 33])
@pytest.mark.parametrize("map_", [False, True])
def test_arguments_in_prototype_order(stub, nhosts, map_):
    """A main-path shard (2 hosts) and others, with boxes (the map's
    pointer null) and with request maps: every argument in the order of
    the C prototype, the block read from its host array, the entry point
    looked up once."""
    lib, looked = stub
    case = _case(nhosts, map_=map_)
    for _ in range(2):
        assert xops.launch_count(case[0], BLOCK, N, case[1], case[2], nhosts,
                                 *case[3:], STREAM) == 0
    seen, block, calls = _seen(lib)
    assert seen == _want(case, nhosts) and block == BLOCK and calls == 2
    assert (seen[7] == 0) == (not map_)
    assert looked.names == ["exchange_count"]


def test_the_coordinate_form_follows_the_shard_cells(stub):
    """Fewer than 2^31 cells in the shard: the 32-bit form (wide 0); from
    2^31 on, the 64-bit one (wide 1); n handed over as a 64-bit int."""
    lib, _ = stub
    big = 2048
    case = _case(2)
    for nz, wide in ((2047, 0), (2048, 1)):
        block = (0, 1024, 0, 1024, 0, nz)
        xops.launch_count(case[0], block, big, case[1], case[2], 2,
                          *case[3:], STREAM)
        seen, got_block, _ = _seen(lib)
        assert seen[11] == wide and got_block == block and seen[3] == big
    assert 1024 * 1024 * 2047 < 2 ** 31 <= 1024 * 1024 * 2048
    cells = torch.zeros(1, dtype=torch.int64).expand(2 ** 32 + 3)
    xops.launch_count(cells, BLOCK, N, case[1], case[2], 2, *case[3:],
                      STREAM)
    assert _seen(lib)[0][1] == 2 ** 32 + 3


@pytest.mark.parametrize("block", [(9, 8, 8, 8, 0, 16), (-1, 8, 8, 8, 0, 16),
                                   (8, 8, 8, 8, 1, 16), (8, 0, 8, 8, 0, 16)])
def test_a_block_outside_the_grid_is_refused(stub, block):
    lib, _ = stub
    case = _case(2)
    with pytest.raises(ValueError, match="not inside"):
        xops.launch_count(case[0], block, N, case[1], case[2], 2, *case[3:],
                          STREAM)
    assert _seen(lib)[2] == 0


@pytest.mark.parametrize("block,big", [((8, 8, 8, 8, 0, 16), N),
                                       ((0, 1024, 0, 1024, 0, 2048), 2048)])
def test_a_box_table_beyond_shared_memory_is_refused(stub, block, big):
    """Boxes need one of their two tables within COUNT_TABLE_INTS: the
    masks, H + 1 + (H + nb // 32)(2 + nx + ny + nz) ints, or the boxes, 6
    nb + H + 1; request maps need none.  On a small shard the masks take
    every box count this test makes; on a large one the boxes' table
    decides."""
    lib, _ = stub
    nb = (xops.COUNT_TABLE_INTS - 3) // 6
    case = list(_case(2))
    for rows, ok in ((nb, True), (nb + 1, big == N)):
        case[1] = torch.zeros((rows, 6), dtype=torch.int32)
        case[2] = torch.tensor([0, rows, rows], dtype=torch.int32)
        if ok:
            xops.launch_count(case[0], block, big, case[1], case[2], 2,
                              *case[3:], STREAM)
            assert _seen(lib)[0][5] == rows
        else:
            with pytest.raises(ValueError, match="ints of table"):
                xops.launch_count(case[0], block, big, case[1], case[2], 2,
                                  *case[3:], STREAM)
    calls = _seen(lib)[2]
    case[3] = torch.zeros((2, 8, 8, 16), dtype=torch.uint8)
    xops.launch_count(case[0], block, big, case[1], case[2], 2, *case[3:],
                      STREAM)
    assert _seen(lib)[0][5] == nb + 1 and _seen(lib)[2] == calls + 1


def test_the_constants_match_the_kernel_source():
    """COUNT_TABLE_INTS and the 256-row counts are csrc/exchange.cu's."""
    path = os.path.join(os.path.dirname(kernels.__file__), os.pardir, "csrc",
                        "exchange.cu")
    src = open(path).read()
    assert int(re.search(r"kCountTableInts = (\d+);", src).group(1)) == \
        xops.COUNT_TABLE_INTS
    assert int(re.search(r"static_assert\(kCountRun == (\d+),",
                         src).group(1)) == xops.THREADS


def test_the_wrapper_launches_a_card_shard(stub, monkeypatch):
    """count on a shard (its device guards made to take CPU tensors):
    outputs of the contract's shapes handed to the kernel, the launch
    counted; a wrong dtype refused before any call."""
    lib, _ = stub
    monkeypatch.setattr(kernels, "plain_or_kernel", lambda name, t: True)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: None)
    cells, boxes, off = _case(33, n=513)[:3]
    before = kernels.LAUNCHES["exchange_count"]
    bits, counts = xops.count(cells, BLOCK, N, boxes, off, 33)
    assert bits.shape == (513, 2) and bits.dtype == torch.int32
    assert counts.shape == (3, 33) and counts.dtype == torch.int32
    assert kernels.LAUNCHES["exchange_count"] == before + 1
    seen, block, calls = _seen(lib)
    assert seen[9] == bits.data_ptr() and seen[10] == counts.data_ptr()
    assert seen[7] == 0 and block == BLOCK and calls == 1
    with pytest.raises(ValueError, match="exchange_count"):
        xops.count(cells.int(), BLOCK, N, boxes, off, 33)
    assert _seen(lib)[2] == 1
