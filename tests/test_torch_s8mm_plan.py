"""The probe s8 GEMM's geometry (``vdtpu_torch/ops/probes.py::s8mm_plan``,
row 12's kernel ``csrc/probe_s8mm.cu``) on the CPU: the K split over a
cluster covers every k once, the ring stages cover each rank's steps, the
tiles and their masked stores cover C once, a numpy emulation of the
kernel's transposer (swizzled tile reads, byte transposes, swizzled B^T
rows) gives wgmma the right operand, and the split-K sum (per-rank s32 partials added in rank
order) equals ``probe_s8mm_plain`` bit for bit, at ``MAX_K`` too."""
import numpy as np
import pytest
import torch

from vdtpu_torch.ops.probes import (
    H100_CLUSTERS, MAX_K, S8MM_MAX_SPLIT, S8MM_STAGE_K, S8MM_TILE_M, S8MM_TILE_N,
    probe_s8mm_plain, s8mm_plan)

torch.set_num_threads(2)

MAX_K16 = MAX_K // 16 * 16
K_CASES = [16, 48, 2880, 4096 + 16, MAX_K16]
MN_CASES = [(4096, 128), (300, 72), (1, 16), (513, 200)]


@pytest.mark.parametrize("m,n", MN_CASES)
@pytest.mark.parametrize("k", K_CASES)
def test_split_covers_every_k_once(m, n, k):
    plan = s8mm_plan(m, n, k)
    assert 1 <= plan.split <= S8MM_MAX_SPLIT and plan.grid[2] == plan.split
    assert plan.tma_b == (n % 16 == 0)
    seen = np.zeros(k, np.int64)
    nk = -(-k // 32)
    assert plan.steps[0][0] == 0 and plan.steps[-1][1] == nk
    for rank, (lo, hi) in enumerate(plan.steps):
        assert hi - lo >= (2 if plan.split > 1 else 1)
        if rank:
            assert lo == plan.steps[rank - 1][1]
        for s in range(lo, hi):
            seen[32 * s:min(32 * s + 32, k)] += 1
        # the ring stages: one TMA box of S8MM_STAGE_K bytes from 32 * lo on,
        # each running its steps once
        stage_steps = [s for first, n_steps in plan.stages(rank)
                       for s in range(first // 32, first // 32 + n_steps)]
        assert stage_steps == list(range(lo, hi))
        assert all(n_steps * 32 <= S8MM_STAGE_K for _, n_steps in plan.stages(rank))
    assert (seen == 1).all()


def test_probe_shape_takes_one_wave():
    """32 row tiles: clusters of 4 would need two waves on an H100 (30 fit),
    clusters of 3 take one (39 fit) with 30 steps a rank; a card holding 32
    clusters of 4 would take 4."""
    plan = s8mm_plan(4096, 128, 2880)
    assert plan.grid == (32, 1, 3)                            # A read once, 96 CTAs
    assert [hi - lo for lo, hi in plan.steps] == [30, 30, 30]
    assert -(-32 // H100_CLUSTERS[plan.split - 1]) == 1
    assert s8mm_plan(4096, 128, 2880, (132, 66, 44, 33)).split == 4
    assert s8mm_plan(4096, 256, 2880).split == 2              # 64 tiles: 66 pairs fit


def _thread_quads():
    """(row, first column) of every s32 quad each consumer thread stores:
    warp w, lane (g, t), quad q = 2 j + e -> row 8 j + 2 t + e, columns
    4 (8 w + g) + [0, 4)."""
    out = []
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for q in range(32):
                out.append((8 * (q >> 1) + 2 * t + (q & 1), 4 * (8 * w + g)))
    return out


@pytest.mark.parametrize("m,n", MN_CASES + [(128, 128), (129, 17)])
def test_tiles_and_masked_stores_cover_c_once(m, n):
    plan = s8mm_plan(m, n, 64)
    hits = np.zeros((plan.grid[0] * S8MM_TILE_M, plan.grid[1] * S8MM_TILE_N), np.int64)
    quads = _thread_quads()
    written = np.zeros((m, n), np.int64)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            m0, n0 = bx * S8MM_TILE_M, by * S8MM_TILE_N
            for r, c in quads:
                hits[m0 + r, n0 + c:n0 + c + 4] += 1
                if m0 + r < m:                       # store_quad's masks
                    for i in range(4):
                        if n0 + c + i < n:
                            written[m0 + r, n0 + c + i] += 1
    assert (hits == 1).all()                         # a tile's threads cover it once
    assert (written == 1).all()                      # every element of C once, no more


def _swizzle128(r, c):
    """Byte offset of (row r, byte c) in a TMA tile of 128-byte rows under the
    128-byte swizzle: 16-byte chunk c / 16 stored at chunk (c / 16) ^ (r % 8)."""
    return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))


def _swizzle64(r, c):
    """The same for 64-byte rows under the 64-byte swizzle: chunk (c / 16) ^
    ((r / 2) % 4)."""
    return r * 64 + ((((c >> 4) ^ ((r >> 1) & 3)) << 4) | (c & 15))


def _transpose4(w):
    """out[i] = byte i of w[0..3], byte j of out[i] from w[j]."""
    b = [[(x >> (8 * i)) & 0xFF for i in range(4)] for x in w]
    return [sum(b[j][i] << (8 * j) for j in range(4)) for i in range(4)]


def _bt_row(c):
    """csrc/probe_s8mm.cu::bt_row: the B^T row (wgmma A row) of tile column c."""
    q, i = c >> 2, c & 3
    return 64 * (i >> 1) + 16 * (q >> 3) + (q & 7) + 8 * (i & 1)


def test_transposer_builds_wgmma_operand():
    """The transposer of a stage: thread (kb, c) reads columns 4 c + [0, 4) of
    k rows 16 kb + [0, 16) from the staged B tile (128-byte swizzle), byte-
    transposes each 4 x 4 block and stores four 16-byte rows of B^T (64-byte
    swizzle, row bt_row(column)). B^T must be B transposed with its rows in
    bt_row order, and wgmma h's accumulator rows 16 w + g (+ 8) must be the
    columns the epilogue stores for thread (w, g): 4 (8 w + g) + 2 h (+ 1)."""
    rs = np.random.RandomState(0)
    tile = rs.randint(0, 256, (S8MM_STAGE_K, S8MM_TILE_N)).astype(np.uint8)   # B [k][n]
    staged = np.zeros(S8MM_STAGE_K * S8MM_TILE_N, np.uint8)
    for r in range(S8MM_STAGE_K):
        for c in range(S8MM_TILE_N):
            staged[_swizzle128(r, c)] = tile[r, c]
    word = lambda off: int.from_bytes(staged[off:off + 4].tobytes(), "little")
    bt = np.zeros(S8MM_TILE_N * S8MM_STAGE_K, np.uint8)
    for kb in range(S8MM_STAGE_K // 16):
        for c in range(32):
            cb = 4 * c
            w = [word(_swizzle128(16 * kb + j, cb)) for j in range(16)]
            cols = [_transpose4(w[4 * jj:4 * jj + 4]) for jj in range(4)]
            for i in range(4):
                r = _bt_row(cb + i)
                row16 = b"".join(cols[jj][i].to_bytes(4, "little") for jj in range(4))
                off = _swizzle64(r, 16 * kb)
                bt[off:off + 16] = np.frombuffer(row16, np.uint8)
    assert sorted(_bt_row(c) for c in range(S8MM_TILE_N)) == list(range(S8MM_TILE_N))
    for c in range(S8MM_TILE_N):
        r = _bt_row(c)
        got = np.array([bt[_swizzle64(r, k)] for k in range(S8MM_STAGE_K)], np.uint8)
        np.testing.assert_array_equal(got, tile[:, c])
    for w in range(4):
        for g in range(8):
            for h in range(2):
                for hr in range(2):
                    assert _bt_row(4 * (8 * w + g) + 2 * h + hr) == 64 * h + 16 * w + g + 8 * hr


def split_k_model(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic in numpy: each rank's s32 partial over its k32
    steps (exact: |partial| <= K * 2^14 < 2^31), then the partials added in
    rank order in s32."""
    m, k = a.shape
    plan = s8mm_plan(m, b.shape[1], k)
    total = np.zeros((m, b.shape[1]), np.int32)
    for lo, hi in plan.steps:
        ks = slice(32 * lo, min(32 * hi, k))
        part = a[:, ks].astype(np.int64) @ b[ks].astype(np.int64)
        assert np.abs(part).max() < 1 << 31
        total = total + part.astype(np.int32)
    return total


@pytest.mark.parametrize("m,k,n,data", [
    (64, 2880, 128, "random"),
    (37, 4096 + 16, 24, "random"),
    (8, MAX_K16, 8, "min"),          # every product +2^14: the s32 range's edge
    (8, MAX_K16, 16, "signs"),       # +-128 operands, sums of both signs
])
def test_split_sum_equals_plain(m, k, n, data):
    rs = np.random.RandomState(k % 1000 + n)
    if data == "random":
        a = rs.randint(-128, 128, (m, k)).astype(np.int8)
        b = rs.randint(-128, 128, (k, n)).astype(np.int8)
    elif data == "min":
        a, b = np.full((m, k), -128, np.int8), np.full((k, n), -128, np.int8)
    else:
        a = np.where(rs.rand(m, k) < 0.5, -128, 127).astype(np.int8)
        b = np.where(rs.rand(k, n) < 0.5, -128, 127).astype(np.int8)
    assert s8mm_plan(m, n, k).split > 1
    ref = probe_s8mm_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(split_k_model(a, b), ref)
    if data == "min":
        assert ref.min() == ref.max() == k * (1 << 14) > 2 ** 31 - 2 ** 20
