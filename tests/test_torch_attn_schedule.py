"""K3's and K4's launch schedules, host side (``ops/attention.py``
``k3_schedule``, ``k4_schedule``), and the ctypes signatures of every
kernel entry point against its C source. The kernels run on the card only
(``chip_smoke.py`` holds them against their plain versions); these are the
pure-Python rules their C entry points follow, checked against the masks
of the plain versions (``_prefill_opts``, ``_decode_opts``) at the
Llama-2-7B, Gemma-2-9B, Bloom/ChatGLM, G = 16/48 and server-chunk
shapes."""
import ctypes
import inspect
import re

import pytest
import torch

from neural_tpu_torch.ops import _cuda
from neural_tpu_torch.ops import attention as A

# (what, B, T, Hq, Hkv, S, D, starts, window, prefix_len)
PREFILLS = [
    ("llama 1975", 1, 1975, 32, 32, 2048, 128, [0], 0, None),
    ("gemma2 6000 window", 1, 6000, 16, 8, 8192, 256, [0], 4096, None),
    ("gemma2 6000", 1, 6000, 16, 8, 8192, 256, [0], 0, None),
    ("gemma2 1975 window", 1, 1975, 16, 8, 2048, 256, [0], 4096, None),
    ("head dim 128 window 1024", 1, 1975, 32, 32, 2048, 128, [0], 1024,
     None),
    ("bloom 1975", 1, 1975, 32, 32, 2048, 128, [0], 0, None),
    ("chatglm 1975 prefix", 1, 1975, 32, 32, 2048, 128, [0], 0, [1975]),
    ("server chunk", 1, 512, 32, 32, 2048, 128, [1024], 0, None),
    ("server chunk int8 window", 2, 512, 32, 32, 2048, 128, [1024, 700],
     300, None),
    ("prefix and window", 2, 700, 8, 4, 1024, 256, [0, 200], 96, [600, 0]),
    ("prefix past the rows", 1, 300, 4, 4, 1024, 128, [100], 64, [900]),
    ("ragged", 3, 130, 4, 2, 500, 128, [0, 5, 370], 0, [0, 7, 1]),
]


def _visible(T, S, start, window, pref):
    """[T, S] bool: the keys each query row sees, by the plain version's
    own mask (scores it leaves above -1e30)."""
    s = torch.zeros((1, 1, 1, T, S))
    prefix = None if pref is None else torch.tensor([pref])
    out = A._prefill_opts(s, torch.tensor([start]), 0.0, window, None, prefix)
    return out[0, 0, 0] > A.NEG / 2


@pytest.mark.parametrize("case", PREFILLS, ids=[c[0] for c in PREFILLS])
def test_k3_tiles_cover_every_visible_key(case):
    _, B, T, Hq, Hkv, S, D, starts, window, prefix = case
    sch = A.k3_schedule(B, T, Hq, Hkv, S, D, starts, window, prefix)
    tk, rows = sch["tile"], sch["rows"]
    n_tb = -(-T // rows)
    assert sch["items"] == B * Hq * n_tb
    assert sch["grid"] == (sch["items"],)      # a block a work item
    # every (b·Hq + h, query block) is one work item
    assert sorted(sch["order"]) == [(bh, tb) for bh in range(B * Hq)
                                    for tb in range(n_tb)]
    for b in range(B):
        vis = _visible(T, S, starts[b], window,
                       None if prefix is None else prefix[b])
        for tb in range(n_tb):
            blk = sch["blocks"][(b, tb)]
            lo, hi = blk["tiles"]
            for w, wg in enumerate(blk["warpgroups"]):
                r0 = tb * rows + w * A.K3_WG_ROWS
                r1 = min(r0 + A.K3_WG_ROWS, T)
                if r0 >= T:
                    assert wg["keys"] is None and not wg["tiles"]
                    continue
                keys = vis[r0:r1].any(dim=0).nonzero().flatten().tolist()
                tiles = set(wg["tiles"])
                assert all(lo <= t < hi for t in tiles)
                assert {k // tk for k in keys} <= tiles
                # a computed tile holds at least one key the rows can see
                assert all(any(t * tk <= k < t * tk + tk for k in keys)
                           for t in tiles)


@pytest.mark.parametrize("case", PREFILLS, ids=[c[0] for c in PREFILLS])
def test_k3_interior_tiles_hold_no_hidden_key(case):
    _, B, T, Hq, Hkv, S, D, starts, window, prefix = case
    sch = A.k3_schedule(B, T, Hq, Hkv, S, D, starts, window, prefix)
    tk, rows = sch["tile"], sch["rows"]
    for b in range(B):
        vis = _visible(T, S, starts[b], window,
                       None if prefix is None else prefix[b])
        for (bb, tb), blk in sch["blocks"].items():
            if bb != b:
                continue
            for w, wg in enumerate(blk["warpgroups"]):
                r0 = tb * rows + w * A.K3_WG_ROWS
                r1 = min(r0 + A.K3_WG_ROWS, T)
                for t in set(wg["tiles"]) - set(wg["masked"]):
                    assert t * tk + tk <= S
                    assert bool(vis[r0:r1, t * tk:t * tk + tk].all())


def test_k3_interior_tiles_carry_the_work():
    """At the Llama prefill every warpgroup masks at most its diagonal
    tiles; the rest of its tiles skip the per-element mask."""
    sch = A.k3_schedule(1, 1975, 32, 32, 2048, 128, [0])
    for blk in sch["blocks"].values():
        for wg in blk["warpgroups"]:
            assert len(wg["masked"]) <= 1


def test_k3_heaviest_query_blocks_first():
    """The work items walk the query blocks from the diagonal's end, all
    heads of one query block together: among the full 128-row blocks the
    work only falls along the order."""
    sch = A.k3_schedule(1, 1975, 32, 32, 2048, 128, [0])
    tbs = [tb for _, tb in sch["order"]]
    assert tbs == sorted(tbs, reverse=True)
    assert [bh for bh, _ in sch["order"][:32]] == list(range(32))
    work = [sum(len(wg["tiles"]) for wg in sch["blocks"][(0, tb)]
                ["warpgroups"]) for tb in tbs if (tb + 1) * sch["rows"] <= 1975]
    assert work == sorted(work, reverse=True) and work[0] > work[-1]


@pytest.mark.parametrize("B,T,start", [(1, 512, 1024), (1, 1975, 0)])
def test_k3_server_chunk_grid(B, T, start):
    """The server's 512-token chunk at start 1024 is 4 query blocks x 32
    heads: 128 blocks, under one wave of the H100; the 1975-token prefill
    512."""
    sch = A.k3_schedule(B, T, 32, 32, 2048, 128, [start])
    assert sch["items"] == 32 * -(-T // 128) == sch["grid"][0]
    if T == 512:
        assert sch["grid"][0] <= A.H100_SMS


# (B, Hq, Hkv, S, D): Llama batch 1 and 8, Gemma-2, Bloom, ChatGLM-2's G =
# 16, StarCoder's G = 48, the server's pool view, a short cache
DECODES = [(1, 32, 32, 2048, 128), (8, 32, 32, 2048, 128),
           (1, 16, 8, 8192, 256), (1, 32, 2, 2048, 128),
           (1, 48, 1, 2048, 128), (8, 32, 2, 2048, 128),
           (4, 96, 1, 333, 128), (1, 32, 32, 80, 128), (3, 8, 8, 700, 256)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", DECODES)
def test_k4_splits_cover_s_once(B, Hq, Hkv, S, D, int8):
    sch = A.k4_schedule(B, Hq, Hkv, S, D, int8=int8)
    chunk, n = sch["chunk"], sch["n_split"]
    assert chunk % sch["tile"] == 0
    covered = [0] * S
    for c in range(n):
        for s in range(c * chunk, min(S, c * chunk + chunk)):
            covered[s] += 1
    assert covered == [1] * S
    assert (n - 1) * chunk < S
    G = Hq // Hkv
    nx, by, gz = sch["grid"]
    assert (nx, by) == (n, B * Hkv)
    assert gz * sch["heads"] >= G and sch["heads"] in A.K4_HEADS


@pytest.mark.parametrize("B,Hq,Hkv,S,D", DECODES)
def test_k4_splits_depend_on_s_never_on_the_fill(B, Hq, Hkv, S, D):
    """The schedule takes no fill and no window; the kernel reads the
    lengths on the device. Each visible key of any fill lies in exactly
    one split, and the splits the kernel skips (past the fill, below the
    window) are the ones the combine skips."""
    params = inspect.signature(A.k4_schedule).parameters
    assert not {"lengths", "fill", "window"} & set(params)
    sch = A.k4_schedule(B, Hq, Hkv, S, D)
    chunk = sch["chunk"]
    for fill in sorted({1, 2, S // 3, S - 1, S}):
        for window in (0, 64, S // 2):
            lens = torch.tensor([fill])
            vis = A._decode_opts(torch.zeros((1, 1, 1, S)), lens, 0.0,
                                 window, None)[0, 0, 0] > A.NEG / 2
            keys = vis.nonzero().flatten().tolist()
            lo = max(fill - window, 0) if window else 0
            run = [c for c in range(sch["n_split"])
                   if max(c * chunk, lo) < min(c * chunk + chunk, fill)]
            assert run == list(range(lo // chunk, -(-fill // chunk)))
            assert sorted(k // chunk for k in keys) == sorted(
                c for c in run for k in keys if k // chunk == c)


@pytest.mark.parametrize("int8", [False, True])
def test_k4_batch1_fills_the_card(int8):
    """Llama-2-7B and Gemma-2-9B at batch 1: 2-4 blocks an SM, every
    block resident at once."""
    for args in ((1, 32, 32, 2048, 128), (1, 16, 8, 8192, 256)):
        sch = A.k4_schedule(*args, int8=int8)
        blocks = sch["grid"][0] * sch["grid"][1] * sch["grid"][2]
        assert 2 * A.H100_SMS <= blocks
        assert blocks <= A.K4_BLOCKS_PER_SM[int8] * A.H100_SMS


# ---------------------------------------------------------------------------
# the ctypes signatures against the C sources
# ---------------------------------------------------------------------------

_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def _param_kind(decl: str) -> str:
    decl = decl.strip()
    if "*" in decl:
        return "pointer"
    if re.match(r"(const\s+)?float\b", decl):
        return "float"
    if re.match(r"(const\s+)?(int|bool)\b", decl):
        return "int"
    raise AssertionError(f"unknown C parameter type: {decl!r}")


def _entry_points(kernel) -> dict:
    """Every ``extern "C"`` function of the kernel's source: name → kinds
    of its parameters, through the entry macros (``NAME``, ``NAME##_asym``)
    of the source and its headers too."""
    texts = [(_cuda.CSRC / f).read_text()
             for f in (kernel.source, *kernel.headers)]
    text = "\n".join(re.sub(r"//[^\n]*", "", t) for t in texts)
    text = text.replace("\\\n", " ")
    sig = re.compile(r'extern\s+"C"\s+int\s+(\w+(?:\s*##\s*\w+)?)\s*'
                     r'\(([^)]*)\)')
    out = {}
    macros = {}
    for m in re.finditer(r"#define\s+(\w+)\(([^)]*)\)(.*)", text):
        name, args, body = m.group(1), m.group(2), m.group(3)
        macros[name] = ([a.strip() for a in args.split(",")], body)
    for m in sig.finditer(text):
        if "##" in m.group(1) or any(m.group(0) in body
                                     for _, body in macros.values()):
            continue
        out[m.group(1)] = [_param_kind(d) for d in m.group(2).split(",")]
    src = re.sub(r"//[^\n]*", "", (_cuda.CSRC / kernel.source).read_text())
    for name, (args, body) in macros.items():
        for call in re.finditer(rf"^{name}\(([^)]*)\)", src, re.M):
            vals = [v.strip() for v in call.group(1).split(",")]
            for fm in sig.finditer(body):
                fn = fm.group(1)
                for a, v in zip(args, vals):
                    fn = re.sub(rf"\b{a}\b", v, fn)
                fn = re.sub(r"\s*##\s*", "", fn)
                out[fn] = [_param_kind(d) for d in fm.group(2).split(",")]
    return out


@pytest.mark.parametrize("kernel", _cuda.KERNELS,
                         ids=[k.source for k in _cuda.KERNELS])
def test_ctypes_signatures_match_the_sources(kernel):
    entries = _entry_points(kernel)
    assert set(kernel.functions) == set(entries), kernel.source
    for fn, argtypes in kernel.functions.items():
        assert [_KIND[a] for a in argtypes] == entries[fn], fn


def test_schedule_constants_match_the_sources():
    """The tiles, rows and ring depths the schedules assume are the ones
    the C sources are built with."""
    k3 = (_cuda.CSRC / "flash_prefill.cu").read_text()
    k4 = (_cuda.CSRC / "decode_body.cuh").read_text()
    assert re.search(r"constexpr int BQ = (\d+);", k3).group(1) == \
        str(A.K3_ROWS)
    assert re.search(r"constexpr int WROWS = (\d+);", k3).group(1) == \
        str(A.K3_WG_ROWS)
    tile = re.search(r"int bkv\(\) \{\s*return D == 128 \? (\d+) : (\d+);",
                     k3)
    assert {128: int(tile.group(1)), 256: int(tile.group(2))} == A.K3_TILE
    nst = re.search(r"int nst\(\) \{\s*return D == 128 \? (\d+) : (\d+);",
                    k3)
    assert {128: int(nst.group(1)), 256: int(nst.group(2))} == A.K3_STAGES
    tk = re.search(r"int tile_keys\(\) \{\s*return D == 128 \? (\d+) : "
                   r"(\d+);", k4)
    assert {128: int(tk.group(1)), 256: int(tk.group(2))} == A.K4_TILE
    assert re.search(r"constexpr int NST = (\d+);", k4).group(1) == \
        str(A.K4_STAGES)
    assert "16 * MT" in k4 and A.K4_HEADS == (16, 64)


def test_k4_has_its_own_body():
    """K4 and K6 share one body: both sources instantiate the templated
    split-S body of decode_body.cuh (TMA ring, mma.sync, the last block's
    merge), each through its own entry points; the earlier split body
    (decode_attn.cuh) is gone."""
    assert _cuda.FLASH_DECODE.headers == ("decode_body.cuh", "qmm_tc.cuh")
    assert _cuda.PAGED_DECODE.headers == _cuda.FLASH_DECODE.headers
    assert "qmm_tc.cuh" in _cuda.FLASH_PREFILL.headers
    assert not (_cuda.CSRC / "decode_attn.cuh").exists()
    body = (_cuda.CSRC / "decode_body.cuh").read_text()
    assert "template <int D, bool I8, int MT, bool PAGED>" in body
    for src, paged in (("flash_decode.cu", "false"),
                       ("paged_decode.cu", "true")):
        text = (_cuda.CSRC / src).read_text()
        assert '#include "decode_body.cuh"' in text
        assert f"decode_body::launch<{paged}, " in text
        assert "__global__" not in text
