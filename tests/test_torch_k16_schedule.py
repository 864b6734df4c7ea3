"""K1's and K6's launch schedules, host side (``ops/qmatmul.py``
``k1_schedule`` / ``k1_items``, ``ops/attention.py`` ``k4_schedule`` /
``k6_boxes`` / ``k6_tile_pages``). The kernels run on the card only
(``chip_smoke.py`` holds them against their plain versions); these are the
pure-Python rules their C entry points follow: K6's tiles and table
lookups against the visible keys of the plain version's mask
(``_decode_opts``), K1's items and merges against the output and K, and
the constants against the C sources."""
import inspect
import re

import pytest
import torch

from neural_tpu_torch.ops import _cuda
from neural_tpu_torch.ops import attention as A
from neural_tpu_torch.ops import qmatmul as Q

PAGE_SIZES = [16, 32, 64, 256]
HEAD_DIMS = [128, 256]
# (B, Hq, Hkv, MAXP·ps capacity): the Llama server's batch 8, Gemma-2's
# pool at batch 1, G = 48 at batch 8
POOLS = [(8, 32, 32, 2048), (1, 16, 8, 8192), (8, 48, 1, 2048)]


def _visible_keys(fill, window, S):
    lens = torch.tensor([fill])
    vis = A._decode_opts(torch.zeros((1, 1, 1, S)), lens, 0.0, window,
                         None)[0, 0, 0] > A.NEG / 2
    return vis.nonzero().flatten().tolist()


def _fills(S):
    return sorted({1, 2, 17, S // 3, S // 2 + 5, S - 1, S})


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("ps", PAGE_SIZES)
def test_k6_tiles_cover_every_visible_key_once(ps, D):
    """Every visible key of a row lies in exactly one box of one split's
    tiles, at every fill and window, over the pools' capacities."""
    br, nb = A.k6_boxes(ps, D)
    assert br * nb == A.K4_TILE[D] and ps % br == 0
    for B, Hq, Hkv, S in POOLS:
        sch = A.k4_schedule(B, Hq, Hkv, S, D)
        chunk = sch["chunk"]
        for fill in _fills(S):
            for window in (0, 64, S // 2):
                keys = _visible_keys(fill, window, S)
                lo = max(fill - window, 0) if window else 0
                seen = [0] * S
                for split in range(sch["n_split"]):
                    kb = max(split * chunk, lo)
                    ke = min(split * chunk + chunk, fill)
                    for key0, _ in A.k6_tile_pages(fill, window, ps, D,
                                                   chunk, split):
                        for k in range(max(key0, kb), min(key0 + br, ke)):
                            seen[k] += 1
                assert [k for k in range(S) if seen[k]] == keys
                assert max(seen) == 1


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("ps", PAGE_SIZES)
def test_k6_reads_no_table_entry_past_the_fill(ps, D):
    """No box reads a table entry past the row's fill or below its window's
    floor: the entries a block reads are those of its visible pages, and a
    box that holds a visible key reads that key's own page. A split with no
    visible key reads none."""
    for B, Hq, Hkv, S in POOLS:
        sch = A.k4_schedule(B, Hq, Hkv, S, D)
        for fill in _fills(S):
            for window in (0, 64, S // 2):
                lo = max(fill - window, 0) if window else 0
                for split in range(sch["n_split"]):
                    reads = A.k6_tile_pages(fill, window, ps, D,
                                            sch["chunk"], split)
                    kb = max(split * sch["chunk"], lo)
                    ke = min(split * sch["chunk"] + sch["chunk"], fill)
                    assert (kb >= ke) == (not reads)
                    for key0, page in reads:
                        assert lo // ps <= page <= (fill - 1) // ps
                        if lo < key0 + A.k6_boxes(ps, D)[0] and key0 < fill:
                            assert page == max(key0, lo) // ps


@pytest.mark.parametrize("B,Hq,Hkv,S", POOLS)
def test_k6_splits_depend_on_the_capacity_never_on_the_fill(B, Hq, Hkv, S):
    """K6 launches with K4's schedule at the pool's capacity MAXP·ps: the
    schedule takes no fill or window, the wrapper passes the capacity, and
    the splits cover it."""
    params = inspect.signature(A.k4_schedule).parameters
    assert not {"lengths", "fill", "window"} & set(params)
    src = inspect.getsource(A._k4_launch)
    call = src.split("k4_schedule(")[1].split(")")[0]
    assert "maxp * ps" in src and "lengths" not in call and "S" in call
    for D in HEAD_DIMS:
        sch = A.k4_schedule(B, Hq, Hkv, S, D)
        assert sch["n_split"] * sch["chunk"] >= S
        assert (sch["n_split"] - 1) * sch["chunk"] < S


@pytest.mark.parametrize("ps", [0, 8, 24, 40])
def test_k6_refuses_page_sizes_off_16(ps):
    with pytest.raises(ValueError):
        A.k6_boxes(ps, 128)


@pytest.mark.parametrize("ps,D,rows", [(16, 128, 16), (32, 128, 32),
                                       (48, 128, 16), (64, 128, 64),
                                       (256, 128, 64), (16, 256, 16),
                                       (32, 256, 32), (256, 256, 32)])
def test_k6_boxes_stay_inside_a_page(ps, D, rows):
    assert A.k6_boxes(ps, D) == (rows, A.K4_TILE[D] // rows)


# (M, K, N): the 7B's products (q/k/v/o, gate/up, down, the lm_head) and
# Gemma-2-9B's, at batch 1, the server's 8 and K1's largest M; a ragged
# product
K1_SHAPES = [(M, K, N) for M in (1, 8, 16)
             for K, N in ((4096, 4096), (4096, 11264), (11264, 4096),
                          (4096, 32000), (3584, 4096), (3584, 2048),
                          (3584, 14336), (14336, 3584))] + \
    [(5, 352, 144), (1, 64, 128), (3, 96, 48)]


@pytest.mark.parametrize("M,K,N", K1_SHAPES)
def test_k1_items_cover_every_output_once(M, K, N):
    """The blocks' column tiles partition the output's columns, their K
    ranges partition K for each tile, and each tile's splits are merged
    once, in split order."""
    sch = Q.k1_schedule(M, K, N)
    work = Q.k1_items(M, K, N)
    assert sch["grid"] == (sch["splits"], sch["tiles"])
    assert len(work["items"]) == sch["splits"] * sch["tiles"]
    cols = {}
    for (sp, t), (nr, kr) in work["items"].items():
        cols.setdefault(t, []).append((sp, nr, kr))
    assert sorted(n for t in cols for n in cols[t][0][1]) == list(range(N))
    for t, parts in cols.items():
        assert all(nr == parts[0][1] for _, nr, _ in parts)
        ks = [k for _, _, kr in sorted(parts, key=lambda p: p[0])
              for k in (kr.start, kr.stop)]
        assert ks[0] == 0 and ks[-1] == K
        assert all(ks[i] == ks[i + 1] for i in range(1, len(ks) - 1, 2))
        assert all(len(kr) > 0 for _, _, kr in parts)   # no empty split
        assert work["merge"][t] == list(range(sch["splits"]))


@pytest.mark.parametrize("M,K,N", K1_SHAPES)
def test_k1_fits_the_card_in_one_wave(M, K, N):
    """K1_BLOCKS_PER_SM blocks fit an SM's shared memory, and the splits fill the
    card's block slots at most once (a product whose column tiles exceed
    them takes no split), unless a block with fewer splits would not fit
    two an SM."""
    sch = Q.k1_schedule(M, K, N)
    assert sch["smem"] == Q.k1_smem(M, sch["stages_per_split"])
    assert sch["smem"] <= Q.K1_SMEM_CAP
    assert Q.K1_BLOCKS_PER_SM * (sch["smem"] + 2048) <= 228 * 1024
    slots = Q.K1_BLOCKS_PER_SM * Q.H100_SMS
    splits, kst = sch["splits"], sch["stages"]
    if splits * sch["tiles"] > max(slots, sch["tiles"]):
        assert Q.k1_smem(M, -(-kst // (splits - 1))) > Q.K1_SMEM_CAP
    if sch["tiles"] >= slots and M == 1:
        assert splits == 1


def test_k1_takes_no_split_where_n_fills_the_card():
    """The lm_head (N = 32000, 250 column tiles) at batch 1 takes no split;
    gate/up (N = 11264, 88 tiles, fewer than the SMs) a few; the square
    products split K."""
    assert Q.k1_schedule(1, 4096, 32000)["splits"] == 1
    assert Q.k1_schedule(1, 4096, 11264)["splits"] <= Q.K1_BLOCKS_PER_SM + 1
    assert Q.k1_schedule(1, 4096, 4096)["splits"] > 1


def test_k1_schedule_depends_on_shapes_alone():
    params = inspect.signature(Q.k1_schedule).parameters
    assert list(params) == ["M", "K", "N", "group", "asym", "n_sm"]


def test_k1_k6_constants_match_the_sources():
    """The tile, stage, ring, padding, warps and blocks an SM that the
    schedules assume are the ones the C sources are built with, and the
    shared-memory formula and K6's box rule are the same."""
    k1 = (_cuda.CSRC / "qmm4_npack.cu").read_text()
    num = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     k1).group(1))
    assert num("TN") == Q.K1_TILE_N
    assert num("STAGE_K") == Q.K1_STAGE_K
    assert num("RING_BYTES") == Q.K1_RING_BYTES
    assert num("XPAD") == Q.K1_XPAD
    assert num("CONSUMERS") == Q.K1_CONSUMERS
    assert num("BLOCKS_PER_SM") == Q.K1_BLOCKS_PER_SM
    assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in k1
    assert "const int g_rows = spk * STAGE_K / group + 2;" in k1
    assert "return 1024 + RING_BYTES + (size_t)M * (spk * STAGE_K + XPAD) " \
        "* 2 +\n         (size_t)CONSUMERS * M * TN * 4 +\n         (asym ? " \
        "(size_t)g_rows * (TN * 4 + M * 4) : (size_t)g_rows * TN * 2);" in k1
    assert "p.spk = (kst + splits - 1) / splits;" in k1
    body = (_cuda.CSRC / "decode_body.cuh").read_text()
    assert "p.br = PAGED ? min(TK, rows & -rows) : TK;" in body
    assert "const int k = min(max(key, lo), len - 1);" in body


def test_k1_tickets_cover_every_column_tile():
    """The ticket counters a device keeps cover the widest product's
    column tiles (a 256000-column lm_head)."""
    assert Q.K1_TICKETS >= Q.k1_schedule(1, 4096, 256000)["tiles"]
    assert "tickets + blockIdx.y" in \
        (_cuda.CSRC / "qmm4_npack.cu").read_text()


def test_decode_tickets_are_per_family():
    """K1 and K4/K6 keep separate ticket counters (``_cuda.tickets``), so
    neither kernel's merge reads the other's counts."""
    assert '"decode"' in inspect.getsource(A._k4_launch)
    assert '"K1"' in inspect.getsource(Q._k1_launch)
