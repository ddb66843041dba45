"""The launch geometry of the gradient-sketch, fp32 and int8 share-step
and SSD kernels, which their wrappers compute in Python
(``grad_sketch.ops.sketch_geometry``, ``ddal_wavg.ops.wavg_geometry``,
``ddal_wavg.ops.wavg_q_geometry``, ``ssd_scan.ops.ssd_geometry``) and
pass to the CUDA entry points, held here on the CPU: every position
falls in exactly one chunk or block, in order, and every (chunk, row
tile, head) of the SSD in exactly one block, whose heads share a group;
the main path's grids hold at least two blocks per SM of the H100 (132
SMs; the SSD's at least one, in one wave); every grid stays within
CUDA's limits. Also on the CPU: the sketch kernel's sign
shortcut against the reference's hash, bitwise, and the kernel's order
of adds (chunks, then a strided sum and a fixed tree) against the plain
version within the sketch's gate.

This file imports only torch; the kernels themselves are held against
their plain versions on the card by ``tests/test_torch_grad_sketch_gpu.py``,
``tests/test_torch_ddal_wavg_gpu.py`` and ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.ddal_wavg import ops as wavg_ops  # noqa: E402
from repro_torch.kernels.grad_sketch import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402

SMS = 132
MAX_X, MAX_YZ, MAX_THREADS = 2 ** 31 - 1, 65535, 1024
LLM_P = 2 ** 22 + 37
SKETCH_SHAPES = [
    (8, 9155, 256),            # the main path
    (8, 1024, 128), (3, 4097, 256), (8, 1000, 128), (16, 2048, 384),
    (1, 1, 1), (1, 7, 3), (9, 31, 256), (17, 33, 256), (2, 70_000, 256),
    (16, LLM_P, 256),          # the LLM-scale plane
    (ops.MAX_ROWS, 1000, 256), (8, 9155, ops.MAX_DIM),
    (1, 2 ** 40 + 3, 1)]
INT8_SHAPES = [(8, 9155), (2, 9155), (1, 1), (1, 65), (3, 1000),
               (16, 2 ** 20 + 37), (wavg_ops.MAX_AGENTS, 9155),
               (1, 2 ** 36 + 5)]


def _chunks_cover(starts_ends, P):
    """Every position in exactly one range, the ranges in order."""
    got = np.concatenate([np.arange(b, e) for b, e in starts_ends])
    return np.array_equal(got, np.arange(P))


@pytest.mark.parametrize("n,P,d", SKETCH_SHAPES)
def test_sketch_geometry_covers_each_position_once(n, P, d):
    geo = ops.sketch_geometry(n, P, d)
    assert geo.chunk % ops.UNROLL == 0 and geo.chunk >= ops.MIN_CHUNK
    # block c takes [c·chunk, min(P, (c + 1)·chunk)): none empty
    assert (geo.chunks - 1) * geo.chunk < P <= geo.chunks * geo.chunk
    if P <= 1_000_000:
        assert _chunks_cover([(c * geo.chunk, min(P, (c + 1) * geo.chunk))
                              for c in range(geo.chunks)], P)
    # rows: the smallest row block that covers n, 16 past that
    assert geo.rows in ops.ROW_BLOCKS
    assert geo.rows >= min(n, 16) and (geo.rows == 1
                                       or geo.rows // 2 < min(n, 16))
    x, y, z = geo.grid(n, d)
    assert 1 <= x <= ops.TARGET_BLOCKS and 1 <= y <= MAX_YZ
    assert 1 <= z <= MAX_YZ
    assert y * ops.DIMS_PER_BLOCK >= d and z * geo.rows >= n
    assert 1 <= geo.reduce_blocks <= MAX_X


@pytest.mark.parametrize("m", [1, 8, 9, 16, 32, 33, wavg_ops.MAX_PIECES])
@pytest.mark.parametrize("n,P", INT8_SHAPES)
def test_int8_geometry_covers_each_position_once(n, P, m):
    geo = wavg_ops.wavg_q_geometry(n, m, P)
    assert wavg_ops.Q_THREADS % 32 == 0 and wavg_ops.Q_THREADS <= MAX_THREADS
    # the kernel's instances: the least batch that covers m (32 past
    # that), and 32 / batch positions per thread or one
    assert (geo.batch, geo.items) in {(32, 1), (16, 1), (16, 2), (8, 1),
                                      (8, 4)}
    assert geo.batch >= min(m, 32) and (geo.batch == 8
                                        or geo.batch // 2 < min(m, 32))
    threads = wavg_ops.Q_THREADS
    span = threads * geo.items
    assert (geo.blocks - 1) * span < P <= geo.blocks * span
    if P <= 1_000_000:
        # block b, thread t: positions b·span + t + i·threads, i < items
        got = np.sort(np.concatenate([
            b * span + t + np.arange(geo.items) * threads
            for b in range(geo.blocks) for t in range(threads)]))
        got = got[got < P]
        assert np.array_equal(got, np.arange(P))
    assert 1 <= geo.blocks <= MAX_X and 1 <= n <= MAX_YZ
    # the weights of MAX_PIECES pieces fit the 48 KB of shared memory a
    # block gets without opting in
    assert wavg_ops.MAX_PIECES * 4 <= 48 * 1024


def test_main_path_grids_hold_two_blocks_per_sm():
    geo = ops.sketch_geometry(8, 9155, 256)
    x, y, z = geo.grid(8, 256)
    assert geo.rows == 8 and x * y * z >= 2 * SMS
    geo = wavg_ops.wavg_q_geometry(8, 32, 9155)
    assert 8 * geo.blocks >= 2 * SMS and (geo.batch, geo.items) == (32, 1)
    # the big plane: four positions per thread, 8-piece batches
    geo = wavg_ops.wavg_q_geometry(16, 8, 2 ** 20 + 37)
    assert (geo.items, geo.batch) == (4, 8)


@pytest.mark.parametrize("n,rows,z", [(1, 1, 1), (2, 2, 1), (5, 8, 1),
                                      (8, 8, 1), (9, 16, 1), (16, 16, 1),
                                      (17, 16, 2)])
def test_sketch_row_block_follows_n(n, rows, z):
    geo = ops.sketch_geometry(n, 9155, 256)
    assert geo.rows == rows and geo.grid(n, 256)[2] == z


def test_int8_geometry_refuses_a_grid_past_cuda_limits():
    with pytest.raises(ValueError, match="grid"):
        wavg_ops.wavg_q_geometry(1, 32, MAX_X * 64 + 1)
    assert wavg_ops.wavg_q_geometry(1, 32, MAX_X * 64) == (1, 32, MAX_X)


@pytest.mark.parametrize("m", [1, 5, 8, 9, 12, 16, 32, 33,
                               wavg_ops.MAX_PIECES])
@pytest.mark.parametrize("n,P", INT8_SHAPES)
def test_fp32_geometry_covers_each_position_once(n, P, m):
    geo = wavg_ops.wavg_geometry(n, m, P)
    threads = wavg_ops.F32_THREADS
    assert threads % 32 == 0 and threads <= MAX_THREADS
    # the kernel's instances: the least batch that covers m (32 past
    # that), and 32 / batch positions per thread or one, so a thread
    # holds at most 32 G values
    assert (geo.batch, geo.items) in {(32, 1), (16, 1), (16, 2), (8, 1),
                                      (8, 4)}
    assert geo.batch * geo.items <= 32
    assert geo.batch >= min(m, 32) and (geo.batch == 8
                                        or geo.batch // 2 < min(m, 32))
    span = threads * geo.items
    assert (geo.blocks - 1) * span < P <= geo.blocks * span
    if P <= 1_000_000:
        # block b, thread t: positions b·span + t + i·threads, i < items,
        # in order along each block and across blocks
        pos = (np.arange(geo.blocks)[:, None, None] * span
               + np.arange(geo.items)[None, :, None] * threads
               + np.arange(threads)[None, None, :]).reshape(-1)
        assert np.array_equal(pos[pos < P], np.arange(P))
    assert 1 <= geo.blocks <= MAX_X and 1 <= n <= MAX_YZ
    # the fused entry's m weights fit the 48 KB of shared memory a block
    # gets without opting in
    assert wavg_ops.MAX_PIECES * 4 <= 48 * 1024


@pytest.mark.parametrize("n", [2, 8])
def test_fp32_main_path_grids_hold_two_blocks_per_sm(n):
    """(n, 32, 9155): one position per thread, 144 blocks per agent, at
    least two blocks per SM of the card."""
    geo = wavg_ops.wavg_geometry(n, 32, 9155)
    assert (geo.batch, geo.items, geo.blocks) == (32, 1, 144)
    assert n * geo.blocks >= 2 * SMS


def test_fp32_big_plane_takes_several_positions_per_thread():
    geo = wavg_ops.wavg_geometry(16, 8, 2 ** 20 + 37)
    assert (geo.items, geo.batch) == (4, 8)
    assert 16 * geo.blocks >= wavg_ops.F32_MIN_BLOCKS_PER_SM * SMS
    # a long plane with 12 pieces: two positions per thread
    assert wavg_ops.wavg_geometry(4, 12, 2 ** 20 + 37)[:2] == (2, 16)


def test_fp32_geometry_refuses_a_grid_past_cuda_limits():
    with pytest.raises(ValueError, match="grid"):
        wavg_ops.wavg_geometry(1, 32, MAX_X * 64 + 1)
    assert wavg_ops.wavg_geometry(1, 32, MAX_X * 64) == (1, 32, MAX_X)
    # with four positions per thread the grid reaches four times as far
    assert wavg_ops.wavg_geometry(1, 8, MAX_X * 256) == (4, 8, MAX_X)
    with pytest.raises(ValueError, match="grid"):
        wavg_ops.wavg_geometry(1, 8, MAX_X * 256 + 1)


# ---------------------------------------------------------------------
# the sketch kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------
def _kernel_sign_bits(seed, start, count, dim):
    """The kernel's sign_of: the reference's hash without its last
    x ^ (x >> 16), then the top bit (int64 holding uint32 values)."""
    pos = torch.arange(count, dtype=torch.int64)[:, None]
    j = torch.arange(dim, dtype=torch.int64)[None, :]
    x = ((int(start) & ref.MASK32) + pos) & ref.MASK32
    x = ((int(seed) & ref.MASK32) + ref._mul32(j, ref._P2)
         + ref._mul32(x, ref._P1)) & ref.MASK32
    x = ref._mul32(x ^ (x >> 15), ref._P2)
    x = ref._mul32(x ^ (x >> 13), ref._P3)
    return x >> 31


@pytest.mark.parametrize("seed,start", [(0, 0), (-7, 11), (12345, 2 ** 31 - 3),
                                        (2 ** 31 - 1, 2 ** 32 - 40)])
def test_kernel_sign_shortcut_is_the_reference_hash(seed, start):
    bits = _kernel_sign_bits(seed, start, 96, 300)
    assert torch.equal(bits, ref.sign_bits(seed, start, 96, 300))
    # the bit into the sign of 1.0f is 1 - 2·bit
    as_float = torch.from_numpy(
        ((bits.numpy().astype(np.uint32) << 31) | 0x3F800000)
        .view(np.float32))
    assert torch.equal(as_float, 1.0 - 2.0 * bits.to(torch.float32))


def _kernel_order_sketch(G, seed, d, offset):
    """The kernel's adds in the kernel's order: each chunk sums its
    positions in order (acc + (±g), exact products), then the second
    pass sums chunks y, y + 16, ... for each y and adds the 16 sums in
    a pairwise tree."""
    n, P = G.shape
    geo = ops.sketch_geometry(n, P, d)
    pad = geo.chunks * geo.chunk - P
    S = ref.sign_block(seed, offset, P, d)
    Gc = torch.nn.functional.pad(G, (0, pad)).reshape(n, geo.chunks,
                                                      geo.chunk)
    Sc = torch.nn.functional.pad(S, (0, 0, 0, pad)).reshape(
        geo.chunks, geo.chunk, d)
    acc = torch.zeros((geo.chunks, n, d))
    for q in range(geo.chunk):
        acc = acc + Gc[:, :, q].T[:, :, None] * Sc[:, q, None, :]
    rows = 16
    part = torch.zeros((rows, n * d))
    for c in range(geo.chunks):
        part[c % rows] = part[c % rows] + acc[c].reshape(-1)
    half = rows // 2
    while half:
        part[:half] = part[:half] + part[half:2 * half]
        half //= 2
    return part[0].reshape(n, d)


@pytest.mark.parametrize("n,P,d,offset", [
    (8, 9155, 256, 0), (8, 1024, 128, 11), (3, 4097, 256, 11),
    (1, 20, 5, 3), (9, 33, 100, 2 ** 32 - 7)])
def test_kernel_order_is_within_the_gate(n, P, d, offset):
    """|got − want| ≤ 1e-5·Σ_p |G[r, p]|, the gate the card holds the
    kernel to, and at the reference's test shapes its rtol 1e-4 / atol
    1e-3."""
    G = torch.from_numpy(np.random.default_rng(n * P).normal(
        size=(n, P)).astype(np.float32))
    got = _kernel_order_sketch(G, -7, d, offset)
    want = ref.sketch_flat(G, -7, d, offset)
    gate = 1e-5 * G.abs().sum(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= gate).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_sass_report_folds_loops():
    """The SASS reader finds a loop by its backward branch, folds runs
    of one opcode and counts the global loads before the first fp add."""
    from repro_torch.kernels import sass
    insns = [(0x00, "MOV", " R1, c[0x0][0x28] "),
             (0x10, "LDG.E.S8", " R2, desc[UR4][R4.64] "),
             (0x20, "LDG.E", " R3, desc[UR4][R6.64] "),
             (0x30, "LDG.E", " R5, desc[UR4][R8.64] "),
             (0x40, "FMUL", " R2, R2, R3 "),
             (0x50, "FADD", " R0, R0, R2 "),
             (0x60, "ISETP.GE.AND", " P0, PT, R9, R10, PT "),
             (0x70, "BRA", " 0x10 "),
             (0x80, "EXIT", " ")]
    assert sass.loops(insns) == [(1, 7)]
    assert sass.fold(["LDG.E", "LDG.E", "FADD"]) == "LDG.E x2 FADD"
    lines = sass.report({"_Z13wavg_q_kernelv": insns}, ["wavg_q"])
    assert lines[0].startswith("[sass] _Z13wavg_q_kernelv: 9 instructions")
    assert "3 global loads (3 before the first fp add)" in lines[1]
    assert sass.report({"_Z3foov": insns}, ["wavg_q"]) == []


def test_sass_comparison_names_kernels_alike_across_versions():
    """Two listings of one source name a kernel with different per-file
    hashes; the comparison matches the kernels by name without them and
    compares every instruction, predicates included."""
    from repro_torch.kernels import sass

    def listing(hash_, insns):
        return "\n".join(
            [f"\t\tFunction : _ZN45_GLOBAL__N__{hash_}_12_ddal_wavg_cu_"
             f"3e6f299613wavg_q_kernelILi8ELi4EEEvPKa"]
            + [f"        /*{16 * k:04x}*/                   {ins} ;"
               f"  /* 0x000fe20000000f00 */"
               for k, ins in enumerate(insns)])
    old = listing("bc6fc148", ["LDC R1, c[0x0][0x28]", "@!P0 LDG.E R2, "
                               "desc[UR4][R4.64]", "EXIT"])
    same = listing("21a44289", ["LDC R1, c[0x0][0x28]", "@!P0 LDG.E R2, "
                                "desc[UR4][R4.64]", "EXIT"])
    other = listing("21a44289", ["LDC R1, c[0x0][0x28]", "@P0 LDG.E R2, "
                                 "desc[UR4][R4.64]", "EXIT"])
    assert list(sass.instructions(old)) == [
        "_ZN13wavg_q_kernelILi8ELi4EEEvPKa"]
    assert sass.same_code(same, old, ["wavg_q"])[0].endswith(
        "the same 3 instructions")
    assert sass.same_code(other, old, ["wavg_q"])[0].endswith(
        "different (3 -> 3 instructions)")
    assert sass.same_code(other, old, ["flash"]) == []


def test_ptxas_report_pairs_each_instance_with_its_counts():
    from repro_torch.kernels import cuda_build
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_113wavg_q_kernelILi8ELi4EEEvPKa' for 'sm_90a'\n"
           "ptxas info    : Function properties for "
           "_ZN12_GLOBAL__N_113wavg_q_kernelILi8ELi4EEEvPKa\n"
           "    24 bytes stack frame, 24 bytes spill stores, 28 bytes spill "
           "loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z3foov' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, used 0 barriers\n")
    (first, *rest), second = cuda_build.ptxas_report(log)
    assert "wavg_q_kernel" in first and rest == [96, 24, 28]
    assert second[1:] == (40, 0, 0)


# (b·nc, l, h, g): the serving path, the edge cases of the card's checks,
# grids that take 1, 2 and 3 heads per bf16 block
SSD_SHAPES = [(8, 256, 48, 1), (8, 1, 2, 1), (8, 63, 4, 1), (3, 65, 4, 2),
              (3, 100, 6, 3), (2, 300, 8, 2), (32, 256, 12, 2),
              (64, 256, 12, 3), (16, 256, 48, 1), (64, 256, 48, 1),
              (4, 256, 48, 1), (1, 1024, 24, 1), (9, 129, 18, 3),
              (ssd_ops.MAX_BN, 64, 2, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bn,l,h,g", SSD_SHAPES)
def test_ssd_geometry_covers_each_chunk_row_tile_and_head_once(bn, l, h, g,
                                                               dtype):
    """Each block (x, y, z) owns row tiles x and tiles − 1 − x (bf16;
    fp32: x alone), heads y·hb .. y·hb + hb − 1 and chunk z: together
    every (chunk, row tile, head) once, no head set across a group."""
    geo = ssd_ops.ssd_geometry(bn, l, h, g, dtype)
    x, y, z = geo.grid
    tiles = -(-l // ssd_ops.TILE)
    assert z == bn and y * geo.heads == h and 1 <= y <= MAX_YZ
    assert 1 <= geo.heads <= ssd_ops.MAX_HEADS and (h // g) % geo.heads == 0
    heads_of = [range(b * geo.heads, (b + 1) * geo.heads) for b in range(y)]
    assert all(len({k // (h // g) for k in hs}) == 1 for hs in heads_of)
    if dtype == torch.float32:
        assert geo.heads == 1 and x == tiles
        rows_of = [{b} for b in range(x)]
    else:
        assert x == -(-tiles // 2)
        rows_of = [{b, tiles - 1 - b} for b in range(x)]
        # every block walks tiles + 1 column tiles, but the middle row
        # tile of an odd count, alone in the last block
        for b, rows in enumerate(rows_of):
            alone = tiles % 2 == 1 and b == x - 1
            assert sum(it + 1 for it in rows) == (tiles // 2 + 1 if alone
                                                  else tiles + 1)
    count = np.zeros((min(z, 3), tiles, h), dtype=int)
    for bz in range(min(z, 3)):
        for bx in range(x):
            for by in range(y):
                for it in rows_of[bx]:
                    count[bz, it, list(heads_of[by])] += 1
    assert (count == 1).all()


def test_ssd_main_path_grid_fills_the_card_in_one_wave():
    """mamba2-780m's prefill, (b·nc, l, h, g) = (8, 256, 48, 1): 3 heads
    a block, 256 blocks of 5 column tiles each, at least one per SM and
    within the two an SM holds; the fp32 grid is (row tile, head,
    chunk)."""
    geo = ssd_ops.ssd_geometry(8, 256, 48, 1, torch.bfloat16)
    x, y, z = geo.grid
    assert geo == (3, (2, 16, 8))
    assert SMS <= x * y * z <= ssd_ops.BLOCKS_PER_SM[3] * SMS
    assert ssd_ops.ssd_geometry(8, 256, 48, 1, torch.float32) == (
        1, (4, 48, 8))


@pytest.mark.parametrize("bn,h,g,heads", [
    (8, 48, 1, 3),           # the main path: 3 heads fill one wave
    (2, 48, 1, 1),           # 3 heads would leave SMs idle
    (1, 4, 1, 1),            # too small to fill the card at all
    (64, 48, 1, 3),          # past one wave whatever the heads
    (64, 12, 3, 2),          # groups of 4 heads: 3 do not divide them
    (32, 12, 2, 3)])
def test_ssd_heads_per_block(bn, h, g, heads):
    """The most heads a block whose grid fills the SMs within one wave;
    a grid too small for that takes one head, one past a wave the most
    that divide the group."""
    assert ssd_ops.ssd_geometry(bn, 256, h, g, torch.bfloat16).heads == heads


@pytest.mark.parametrize("bn,l,h,g", [(ssd_ops.MAX_BN + 1, 256, 48, 1),
                                      (1, 256, ssd_ops.MAX_BN + 1, 1),
                                      (0, 256, 48, 1), (8, 0, 48, 1),
                                      (8, 256, 48, 5)])
def test_ssd_geometry_refuses_a_grid_past_cuda_limits(bn, l, h, g):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="grid"):
            ssd_ops.ssd_geometry(bn, l, h, g, dtype)
