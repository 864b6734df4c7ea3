"""K2's and K5's launch schedules, host side (``ops/qmatmul.py``): the
route K5 takes by M, and that the grids of both kernels cover every output
element once, with each K split a whole number of K steps, at the
Llama-2-7B product shapes and the server's chunk buckets. The kernels
themselves run on the card only (``chip_smoke.py`` holds them against
their plain versions); these are the pure-Python rules their C entry
points follow."""
import pytest

from neural_tpu_torch.ops import _cuda
from neural_tpu_torch.ops import qmatmul as Q

# Llama-2-7B's products (K, N): q/k/v/o, gate/up, down, the lm_head
SHAPES_7B = [(4096, 4096), (4096, 11264), (11264, 4096), (4096, 32000)]
# decode at batch 1 and 8, the server's chunk buckets, the 24- and
# 64-token prompts, a ragged prefill and the 1975-token one
MS = [1, 2, 3, 8, 16, 17, 24, 32, 64, 128, 129, 300, 1975]


def _covers_once(starts_ends, total):
    """The ranges [start, end) partition [0, total)."""
    covered = [0] * total
    for a, b in starts_ends:
        for i in range(a, b):
            covered[i] += 1
    return covered == [1] * total


@pytest.mark.parametrize("M", list(range(1, 41)) + [64, 128, 256, 1975])
def test_k5_route_is_gemv_exactly_at_m_le_16(M):
    assert Q.k5_route(M) == ("gemv" if M <= 16 else "tc")
    assert Q.k5_schedule(M, 4096, 4096)["route"] == Q.k5_route(M)


@pytest.mark.parametrize("K,N", SHAPES_7B)
@pytest.mark.parametrize("M", MS)
def test_k5_grid_covers_every_output_once(M, K, N):
    sch = Q.k5_schedule(M, K, N)
    nx, splits, nz = sch["grid"]
    rows, kps, step = sch["rows"], sch["kps"], sch["k_step"]
    assert splits == sch["splits"]
    # rows of x: the M blocks' rows, the last one ragged
    assert _covers_once([(z * rows, min(M, z * rows + rows))
                         for z in range(nz)], M)
    assert (nz - 1) * rows < M
    # output columns: 128 a block, the last one ragged
    assert _covers_once([(x * Q.K5_BN, min(N, x * Q.K5_BN + Q.K5_BN))
                         for x in range(nx)], N)
    # K: each split a whole number of K steps, the last one ragged
    assert kps % step == 0
    assert _covers_once([(y * kps, min(K, y * kps + kps))
                         for y in range(splits)], K)
    assert (splits - 1) * kps < K


@pytest.mark.parametrize("K,N", SHAPES_7B)
@pytest.mark.parametrize("M", MS)
def test_k5_splits_by_route(M, K, N):
    """gemv: one split per 512 K rows; tc: a split only below one wave of
    output tiles, at most K5_MAX_SPLITS, each with >= 4 K tiles."""
    splits, kps = Q.k5_splits(M, K, N)
    if M <= 16:
        assert kps == Q.K5_GEMV_K and splits == -(-K // Q.K5_GEMV_K)
        assert Q.k5_rows(M) in (1, 2, 4, 8) and Q.k5_rows(M) >= min(M, 8)
        return
    rows = Q.k5_rows(M)
    assert rows == (128 if M <= 128 else 256)
    tiles = -(-N // Q.K5_BN) * -(-M // rows)
    if tiles >= Q.K5_TARGET_BLOCKS:
        assert splits == 1
    assert splits <= Q.K5_MAX_SPLITS
    assert kps // Q.K5_BK >= 4 or splits == 1


def test_k5_server_chunk_fills_the_card():
    """The q4_j server's 128-token chunk (tc route, one 128-row tile): K
    is split so that the 4096-wide products fill one wave of the H100."""
    sch = Q.k5_schedule(128, 4096, 4096)
    nx, splits, nz = sch["grid"]
    assert (sch["route"], sch["rows"], nz) == ("tc", 128, 1)
    assert nx * splits * nz <= Q.K5_TARGET_BLOCKS
    assert nx * splits * nz > Q.K5_TARGET_BLOCKS // 2


@pytest.mark.parametrize("K,N", SHAPES_7B[:3] + [(3584, 14336)])
@pytest.mark.parametrize("M", [256, 300, 512, 1975, 6000])
def test_k2_grid_covers_every_output_once(M, K, N):
    sch = Q.k2_schedule(M, K, N)
    nx, nz = sch["grid"]
    assert _covers_once([(z * sch["rows"], min(M, z * sch["rows"] +
                                              sch["rows"]))
                         for z in range(nz)], M)
    assert nx * sch["cols"] == N          # K2 takes N % 128 == 0
    assert K % sch["k_step"] == 0         # gd % 128 == 0 and K % gd == 0
    gd = Q._pick_a8(M, K, N, _FakeQT())
    assert gd is not None and gd % sch["k_step"] == 0


class _FakeQT:
    """The fields of a q4_j weight that ``_pick_a8`` reads."""

    class cfg:
        kind, act_bits, bits = "int", 8, 4

    group_size = 128


def test_k5_routes_are_counted_apart():
    """Each K5 launch also counts under its route, so that a run's launch
    counts show which route each path took."""
    assert {"qmm_general", "qmm_general+gemv", "qmm_general+tc"} \
        <= set(_cuda.launch_counts())
    assert "qmm_tc.cuh" in _cuda.QMM_GENERAL.headers
    assert "qmm_tc.cuh" in _cuda.QMM_A8.headers
