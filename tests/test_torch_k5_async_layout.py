"""K5's async producer against TMA's box layout, on the CPU.

Where TMA cannot describe a bf16 operand (a width not a multiple of 8, a
base off 16 bytes), K5's wgmma kernels fill their ring through cp.async
(``copy_box`` in ``csrc/grouped_matmul.cu``): producer thread p makes
copies p, p + P, ... of a 64 x 64 box's 8192 / W copies of W bytes in row
order, copy (r, q) to shared byte r * 128 + ((q W / 16) ^ (r % 8)) * 16 +
(q W) % 16, zero where its row is at or past the box's row bound or its
column at or past the column bound.  The consumers' descriptors
(``gmma_desc``) read the layout of TMA's SWIZZLE_128B box: element (r, c)
at r * 128 + ((c // 8) ^ (r % 8)) * 16 + (c % 8) * 2, zeros past the
edges.  cp.async takes no 2-byte copy, so at W = 2 a warp takes a row
(``copy_chunks``): its 64 elements start s = 0, 2, ..., 14 bytes into an
aligned 16-byte chunk, and the warp copies the row's 8 or 9 aligned
chunks (the ninth to a side slot), then (``realign_chunks``) lane t
shifts the pair of elements 2 t, 2 t + 1 out of two of those words (a
funnel shift by 8 (s % 4) bits) and stores it where TMA's box has it.  A
numpy model of both, run at each copy width W (16,
8, 4, 2 bytes) for each box the kernels load (x, the forward's w, w read
K-major for dX, dW's x and dy), must write every byte of the box once and
give TMA's image, its zeros exactly on the ragged edges and the rows past
the count.  The float32 kernels' producers (``copy_rows``) fill the same
way the boxes of their TMA rings: the forward's x (64 rows x 32 floats)
and w (32 deep x 256 columns), unswizzled; dX's w read K-major (256 rows
x 32 floats, the 128-byte swizzle: chunk c of row n at c ^ (n % 8)); dW's
x (32 rows x 64 columns) and dy (32 rows x 128 columns), unswizzled.  A
numpy model of ``copy_rows`` (a thread a column of copies, or, where a
row holds more copies than there are producers, several columns of every
row) at 16, 8 and 4 bytes must give TMA's image of each the same way.
The width W is ``kernel.copy_bytes``: the widest
that divides the row pitch and the base, so a copy never straddles the
column bound and every copy is aligned; it is tested on CPU tensors and
offset views.
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.grouped_matmul import kernel as gkernel  # noqa: E402

SOURCE = pathlib.Path(gkernel.LIBRARY.source)
BOX = 64  # rows and bf16 columns of a box: 128 bytes a row


def source_producers() -> int:
    """The producer threads of the source's async instances."""
    warps = re.search(r"constexpr int kAsyncProducerWarps = (\d+);",
                      SOURCE.read_text())
    assert warps, "kAsyncProducerWarps is not in the source"
    return 32 * int(warps.group(1))


def source_dw_f32_producers() -> int:
    """The producer threads of the source's f32 async dW."""
    n = re.search(r"constexpr int kDwF32AsyncProducers = (\d+);",
                  SOURCE.read_text())
    assert n, "kDwF32AsyncProducers is not in the source"
    return int(n.group(1))


def tma_box(mem, pitch, r0, nrows, c0, ncols):
    """The 4096 bf16 slots (byte address / 2) of TMA's SWIZZLE_128B box of
    rows [r0, r0 + 64) x columns [c0, c0 + 64) of the matrix in ``mem``
    (``pitch`` elements a row), zeros past nrows and ncols."""
    r, c = np.meshgrid(np.arange(BOX), np.arange(BOX), indexing="ij")
    addr = r * 128 + ((c // 8) ^ (r % 8)) * 16 + (c % 8) * 2
    inside = (r0 + r < nrows) & (c0 + c < ncols)
    src = np.where(inside, (r0 + r) * pitch + c0 + c, 0)
    box = np.zeros(BOX * BOX, np.int64)
    box[addr.ravel() // 2] = np.where(inside, mem[src], 0).ravel()
    return box, inside


def async_box(mem, pitch, r0, nrows, c0, ncols, width, producers):
    """``copy_box<width>``'s writes (width 16, 8 or 4) with ``producers``
    threads: (the box's 4096 slots, how many times each was written, the
    element index each real copy starts at)."""
    per = 128 // width
    step = producers // per
    box = np.full(BOX * BOX, -1, np.int64)
    writes = np.zeros(BOX * BOX, np.int64)
    reads = []
    for p in range(producers):
        q = p % per
        col = c0 + q * (width // 2)
        at = (q * width) & 15
        chunk = (q * width) >> 4
        for i in range(BOX // step):
            r = p // per + i * step
            ok = col < ncols and r0 + r < nrows
            addr = at + r * 128 + ((chunk ^ (r & 7)) << 4)
            if ok:
                reads.append((r0 + r) * pitch + col)
            for e in range(width // 2):
                slot = addr // 2 + e
                box[slot] = mem[(r0 + r) * pitch + col + e] if ok else 0
                writes[slot] += 1
    return box, writes, reads


def chunk_box(mem, pitch, r0, nrows, c0, ncols, base, warps):
    """The 2-byte tier (``copy_chunks``, then ``realign_chunks``), a warp
    for every warps-th row: the box's slots, how many times each was
    written, and the byte addresses of the 16-byte chunks read.  ``mem``
    holds the matrix's elements from byte address ``base`` (any even
    address), with other bytes around it, as memory would."""
    def byte(addr):
        i, hi = divmod(addr - base, 2)
        if not 0 <= i < len(mem):
            return 0xEF  # not ours
        return (int(mem[i]) >> (8 * hi)) & 0xFF

    box = np.full(BOX * BOX, -1, np.int64)
    writes = np.zeros(BOX * BOX, np.int64)
    reads = []
    for warp in range(warps):
        for r in range(warp, BOX, warps):
            a = base + 2 * ((r0 + r) * pitch + c0)
            s = a % 16
            ch = a - s
            row = r0 + r < nrows
            raw = []
            for c in range(9):  # the pass through cp.async
                ok = row and (c0 + max((16 * c - s) // 2, 0) < ncols
                              if c < 8 else
                              s != 0 and c0 + (128 - s) // 2 < ncols)
                if ok:
                    reads.append(ch + 16 * c)
                raw += [byte(ch + 16 * c + k) if ok else 0
                        for k in range(16)]
            words = [int.from_bytes(bytes(raw[4 * k:4 * k + 4]), "little")
                     for k in range(36)]
            for t in range(32):  # the pass in shared memory
                q = s // 4 + t
                both = words[q] | (words[q + 1] << 32)
                out = (both >> (8 * (s % 4))) & 0xFFFFFFFF
                e = c0 + 2 * t
                if e + 1 >= ncols:
                    out = out & 0xFFFF if e < ncols else 0
                addr = r * 128 + (((t >> 2) ^ (r & 7)) << 4) + 4 * (t & 3)
                for half in range(2):
                    box[addr // 2 + half] = (out >> (16 * half)) & 0xFFFF
                    writes[addr // 2 + half] += 1
    return box, writes, reads


def case(kind, width):
    """(rows, cols of the matrix, r0, nrows, c0) of one box the kernels
    load, its columns chosen so that ``copy_bytes`` gives ``width``: a
    row of 1024 / 1020 / 1022 / 1021 elements."""
    cols = {16: 1024, 8: 1020, 4: 1022, 2: 1021}[width]
    edge = (cols - 1) // 64 * 64  # the last column box: ragged below 1024
    if kind == "x":  # x (T, d): a row tile's second box, 37 real rows
        return 512, cols, 64, 64 + 37, edge
    if kind == "w":  # the forward's w (d, f): the last 40 deep of d = 1000
        return 1000, cols, 960, 1000, 128
    if kind == "w_kmajor":  # dX's w stored (f, d): rows are f (the
        # output), columns d (the depth), d's last box
        return 1000, cols, 64, 1000, edge
    if kind == "dw_x":  # dW's x: 17 real rows of a tile
        return 768, cols, 128, 128 + 17, 256
    if kind == "dw_dy":  # dW's dy: the f edge, every row real
        return 768, cols, 192, 256, edge
    raise ValueError(kind)


KINDS = ["x", "w", "w_kmajor", "dw_x", "dw_dy"]


@pytest.mark.parametrize("producers", [128, 64], ids=["warpgroup", "2warps"])
@pytest.mark.parametrize("width", [16, 8, 4, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_async_box_is_tma_box(kind, width, producers):
    """Every byte of the box written once, in TMA's SWIZZLE_128B place,
    the zeros exactly past the row bound (the count) and the column bound
    (the ragged edge).  At 16, 8 and 4 bytes each copy is aligned to its
    width and wholly inside or wholly outside the row; at 2 bytes (on
    bases 0, 2, 6 and 14 bytes past 16) every chunk read is aligned and
    holds an element of the matrix."""
    rows, cols, r0, nrows, c0 = case(kind, width)
    t = torch.zeros(rows, cols, dtype=torch.bfloat16)
    assert gkernel.copy_bytes(t) == width
    mem = np.arange(1, rows * cols + 1, dtype=np.int64) % 65521 + 1
    want, inside = tma_box(mem, cols, r0, nrows, c0, cols)
    r, c = np.meshgrid(np.arange(BOX), np.arange(BOX), indexing="ij")
    addr = (r * 128 + ((c // 8) ^ (r % 8)) * 16 + (c % 8) * 2) // 2
    zero = np.zeros(BOX * BOX, bool)
    zero[addr.ravel()] = ~inside.ravel()
    assert zero.any() == (width < 16 or kind in ("x", "w", "dw_x"))
    bases = [0] if width > 2 else [0, 2, 6, 14]
    for base in bases:
        if width > 2:
            got, writes, reads = async_box(mem, cols, r0, nrows, c0, cols,
                                           width, producers)
            for elem in reads:
                assert (elem * 2) % width == 0  # aligned on an aligned base
                assert elem % cols + width // 2 <= cols  # inside the row
        else:
            got, writes, reads = chunk_box(mem, cols, r0, nrows, c0, cols,
                                           1024 + base, producers // 32)
            for c in reads:  # aligned, and holding an element of ours
                first = (c - 1024 - base) // 2
                assert c % 16 == 0 and -8 < first < rows * cols
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want)
        assert ((got == 0) == zero).all()


# The float32 boxes: (rows of the box, its bytes a row, swizzled), and one
# box each kernel loads as (matrix rows, r0, nrows, c0 from the ragged
# edge of ``cols``): the forward's x (a row tile's 37 real rows, the last
# depth stage), its w (the last 8 deep of d = 1000, the last column box),
# dX's w stored (f, d) (f's last 256-row box, d's last stage), dW's x (17
# real rows) and dy (every row real, the f edge).
F32_BOXES = {
    "x": (64, 128, False), "w": (32, 1024, False),
    "w_kmajor": (256, 128, True), "dw_x": (32, 256, False),
    "dw_dy": (32, 512, False),
}
F32_COLS = {16: 1024, 8: 1022, 4: 1021}  # copy_bytes of an f32 row


def f32_case(kind, cols):
    rows, row_bytes, _ = F32_BOXES[kind]
    box_cols = row_bytes // 4
    edge = (cols - 1) // box_cols * box_cols
    return {"x": (512, 64, 64 + 37, edge), "w": (1000, 992, 1000, edge),
            "w_kmajor": (1000, 768, 1000, edge),
            "dw_x": (768, 128, 128 + 17, edge),
            "dw_dy": (768, 192, 224, edge)}[kind]


def f32_slot(r, c, row_bytes, swizzle):
    """The byte address / 4 of element (r, c) in TMA's box."""
    byte = c * 4
    if swizzle:
        return (r * 128 + (((byte >> 4) ^ (r % 8)) << 4) + (byte & 15)) // 4
    return (r * row_bytes + byte) // 4


def tma_f32_box(mem, pitch, r0, nrows, c0, ncols, rows, row_bytes, swizzle):
    """TMA's image of an f32 box (zeros past nrows and ncols) and where it
    holds zeros."""
    box = np.zeros(rows * row_bytes // 4, np.int64)
    zero = np.zeros(box.size, bool)
    for r in range(rows):
        for c in range(row_bytes // 4):
            slot = f32_slot(r, c, row_bytes, swizzle)
            inside = r0 + r < nrows and c0 + c < ncols
            box[slot] = mem[(r0 + r) * pitch + c0 + c] if inside else 0
            zero[slot] = not inside
    return box, zero


def copy_rows_model(mem, pitch, r0, nrows, c0, ncols, rows, row_bytes,
                    swizzle, width, producers):
    """``copy_rows``'s writes at ``width`` bytes with ``producers``
    threads: (the box's slots, times each was written, the element index
    each real copy reads from)."""
    per = row_bytes // width  # copies a box row
    elems = width // 4
    assert producers % per == 0 or per % producers == 0
    box = np.full(rows * row_bytes // 4, -1, np.int64)
    writes = np.zeros(box.size, np.int64)
    reads = []

    def copy(r, q):
        col = c0 + q * elems
        ok = col < ncols and r0 + r < nrows
        byte = q * width
        if swizzle:
            addr = r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)
        else:
            addr = r * row_bytes + byte
        if ok:
            reads.append((r0 + r) * pitch + col)
        for e in range(elems):
            box[addr // 4 + e] = mem[(r0 + r) * pitch + col + e] if ok else 0
            writes[addr // 4 + e] += 1

    for p in range(producers):
        if producers % per == 0:  # a column a thread
            step = producers // per
            for i in range(rows // step):
                copy(p // per + i * step, p % per)
        else:  # several columns of every row
            for r in range(rows):
                for j in range(per // producers):
                    copy(r, p + j * producers)
    return box, writes, reads


@pytest.mark.parametrize("producers", ["source", 64],
                         ids=["source", "2warps"])
@pytest.mark.parametrize("width", [16, 8, 4])
@pytest.mark.parametrize("kind", list(F32_BOXES))
def test_f32_async_box_is_tma_box(kind, width, producers):
    """The float32 producers' copies at each width write every byte of
    the box once, in TMA's place, TMA's image with its zeros exactly past
    the row bound (the count) and the column bound (the ragged edge); each
    copy aligned to its width and wholly inside the row."""
    if producers == "source":
        producers = (source_dw_f32_producers() if kind.startswith("dw")
                     else source_producers())
    rows, row_bytes, swizzle = F32_BOXES[kind]
    cols = F32_COLS[width]
    mrows, r0, nrows, c0 = f32_case(kind, cols)
    t = torch.zeros(mrows, cols, dtype=torch.float32)
    assert gkernel.copy_bytes(t) == width
    mem = np.arange(1, mrows * cols + 1, dtype=np.int64) * 7 % 1000003 + 1
    want, zero = tma_f32_box(mem, cols, r0, nrows, c0, cols, rows,
                             row_bytes, swizzle)
    assert zero.any() == (width < 16 or kind != "dw_dy")
    got, writes, reads = copy_rows_model(mem, cols, r0, nrows, c0, cols,
                                         rows, row_bytes, swizzle, width,
                                         producers)
    for elem in reads:
        assert (elem * 4) % width == 0  # aligned on an aligned base
        assert elem % cols + width // 4 <= cols  # inside the row
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)
    assert ((got == 0) == zero).all()


def test_source_producers_are_modelled():
    """The model's thread counts include the source's."""
    assert source_producers() in (128, 64)
    assert source_dw_f32_producers() in (128, 64)


def test_producer_threads_cover_box_rows():
    """Each copy width's copies a row divide the source's producers, so a
    thread keeps one column of the box (``copy_box``'s static_assert)."""
    for width in (16, 8, 4, 2):
        assert source_producers() % (128 // width) == 0


BF16, F32 = torch.bfloat16, torch.float32
COPY_CASES = {  # (shape, offset of the base in elements, width, dtype)
    "aligned": ((4, 1024), 0, 16, BF16),
    "f1020": ((4, 1020), 0, 8, BF16),
    "f1022": ((4, 1022), 0, 4, BF16),
    "f1021": ((4, 1021), 0, 2, BF16),
    "base8": ((4, 1024), 4, 8, BF16),
    "base4": ((4, 1024), 2, 4, BF16),
    "base2": ((4, 1024), 1, 2, BF16),
    "base12": ((4, 1024), 6, 4, BF16),
    "f1020_base4": ((4, 1020), 2, 4, BF16),
    "stack": ((3, 64, 1020), 0, 8, BF16),
    "stack_base8": ((3, 64, 1024), 4, 8, BF16),
    "f32_aligned": ((4, 1024), 0, 16, F32),
    "f32_f1022": ((4, 1022), 0, 8, F32),
    "f32_f1021": ((4, 1021), 0, 4, F32),
    "f32_base4": ((4, 1024), 1, 4, F32),
    "f32_base8": ((4, 1024), 2, 8, F32),
    "f32_base12": ((4, 1024), 3, 4, F32),
    "f32_f1022_base8": ((4, 1022), 2, 8, F32),
    "f32_stack": ((3, 64, 1022), 0, 8, F32),
}


@pytest.mark.parametrize("shape,offset,width,dtype", list(COPY_CASES.values()),
                         ids=list(COPY_CASES))
def test_copy_bytes_by_pitch_and_base(shape, offset, width, dtype):
    """``copy_bytes``: the widest of 16, 8, 4, 2 bytes dividing the row
    pitch and the base address (an offset view of a buffer); a float32
    operand's is 4 at least."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    t = buf[offset:offset + n].view(shape)
    assert gkernel.copy_bytes(t) == width
    pitch = shape[-1] * buf.element_size()
    assert pitch % width == 0 and t.data_ptr() % width == 0
    if width < 16:
        assert pitch % (2 * width) or t.data_ptr() % (2 * width)


# ids as the cases were named before the paths "elem" and "f32_elem" were
# renamed "async" and "f32_async"
@pytest.mark.parametrize("path", ["tma", "async", "f32", "f32_async"],
                         ids=["tma", "elem", "f32", "f32_elem"])
def test_widths_only_on_the_async_path(path):
    """The launch entries read copy widths on the paths TMA cannot
    describe only (bf16 and f32); the TMA paths pass 0s."""
    dtype = torch.float32 if path.startswith("f32") else torch.bfloat16
    x = torch.zeros(4, 1022 if dtype == torch.float32 else 1020, dtype=dtype)
    w = torch.zeros(2, x.shape[1], 1021, dtype=dtype)
    got = gkernel._widths(path, x, w)
    assert got == {"async": (8, 2), "f32_async": (8, 4)}.get(path, (0, 0))
