"""The plain reference: a Mistral / Mixtral decoder in float32, written from
the published architecture (Mistral 7B, arXiv:2310.06825; Mixtral of
Experts, arXiv:2401.04088) with plain torch operations.

It regenerates the benchmark's seeded weights (``benchmark.weights``),
rounds every projection by the q4_j rule in its own code (:func:`q4j`),
and runs teacher-forced over whole sequences, one layer at a time, so that
full-depth Mixtral fits beside nothing else on the card. TF32 is off.
Departures from the published model: none in the mathematics; Mistral's
4096-token sliding window never binds at the lengths served (every
sequence is shorter than 4096).

It imports nothing of the program under test and takes no tensor that the
program made.

``act_bits`` / ``kv_bits`` lower the precision for the control of the
correctness check: the inputs of every projection rounded per row and per
group of 128 to signed ``act_bits`` integers at the positions from
``low_from`` on (the decode steps' inputs; every position without it),
and the keys and values rounded per token and head to ``kv_bits``
integers at every position (the whole cache).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..weights import Shapes, layer_weights, top_weights

GROUP = 128


def q4j(w: torch.Tensor) -> torch.Tensor:
    """q4_j of an ``[out, in]`` weight, as the float32 ``[in, out]`` matrix
    it stands for: groups of 128 along the input, scale = absmax / 8 (+1e-9)
    in float32, codes round(w / scale) (half to even) clamped to [-8, 7],
    scales kept in bf16 (the configuration's stated scale type)."""
    w = w.to(torch.float32).t()                   # [K, N]
    K, N = w.shape
    wg = w.reshape(K // GROUP, GROUP, N)
    scale = wg.abs().amax(dim=1) / torch.full((), 8.0, device=w.device) \
        + 1e-9
    codes = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7)
    scale = scale.to(torch.bfloat16).to(torch.float32)
    return (codes * scale[:, None, :]).reshape(K, N)


def fake_int(x: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """Symmetric round-to-nearest of ``x`` to signed ``bits`` integers, per
    group of ``group`` along the last axis."""
    shp = x.shape
    xg = x.reshape(*shp[:-1], shp[-1] // group, group)
    q = (1 << (bits - 1)) - 1
    s = xg.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / q
    return (torch.clamp(torch.round(xg / s), -q, q) * s).reshape(shp)


class Reference:
    """Teacher-forced logits of a list of token sequences."""

    def __init__(self, hf: dict, seed: int, device, act_bits: int = 0,
                 kv_bits: int = 0, low_from: Optional[List[int]] = None):
        self.hf, self.seed, self.device = hf, seed, device
        self.s = Shapes(hf)
        self.eps = hf.get("rms_norm_eps", 1e-5)
        self.theta = float(hf.get("rope_theta", 10000.0))
        self.act_bits, self.kv_bits = act_bits, kv_bits
        self.low_from = low_from

    # -- pieces ---------------------------------------------------------
    def _norm(self, x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * w

    def _low(self, x, j, bits, group, everywhere=False):
        """``x`` [T, ...] with the rows from this sequence's ``low_from``
        (all rows with ``everywhere``) rounded to ``bits``."""
        if not bits:
            return x
        b = 0 if self.low_from is None or everywhere else self.low_from[j]
        x = x.clone()
        x[b:] = fake_int(x[b:], bits, group)
        return x

    def _lin(self, x, w, j):
        return self._low(x, j, self.act_bits, GROUP) @ w

    def _rope(self, x, T):
        Dh = self.s.Dh
        inv = 1.0 / (self.theta ** (torch.arange(0, Dh, 2, dtype=torch.float64,
                                                 device=x.device) / Dh))
        ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
            * inv[None]
        cos = torch.cat([ang.cos(), ang.cos()], -1).to(torch.float32)
        sin = torch.cat([ang.sin(), ang.sin()], -1).to(torch.float32)
        x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
        rot = torch.cat([-x2, x1], -1)
        return x * cos[:, None] + rot * sin[:, None]

    def _attn(self, x, W, j):
        s = self.s
        T = x.shape[0]
        q = self._lin(x, W["q"], j).view(T, s.H, s.Dh)
        k = self._lin(x, W["k"], j).view(T, s.Hkv, s.Dh)
        v = self._lin(x, W["v"], j).view(T, s.Hkv, s.Dh)
        q, k = self._rope(q, T), self._rope(k, T)
        k = self._low(k, j, self.kv_bits, s.Dh, everywhere=True)
        v = self._low(v, j, self.kv_bits, s.Dh, everywhere=True)
        rep = s.H // s.Hkv
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # [H, T, Dh]
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        sc = (q @ k.transpose(1, 2)) / (s.Dh ** 0.5)
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
        sc.masked_fill_(mask, float("-inf"))
        o = torch.softmax(sc, dim=-1) @ v                    # [H, T, Dh]
        return self._lin(o.transpose(0, 1).reshape(T, s.H * s.Dh), W["o"], j)

    def _mlp(self, x, g, u, d, j):
        h = torch.nn.functional.silu(self._lin(x, g, j)) * self._lin(x, u, j)
        return self._lin(h, d, j)

    def _moe(self, x, W, j):
        s = self.s
        logits = x @ W["router"]                               # [T, E]
        p = torch.softmax(logits, dim=-1)
        top_p, top_i = torch.topk(p, s.k, dim=-1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(s.E):
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            y = self._mlp(x[rows], *W["experts"][e], j)
            out.index_add_(0, rows, y * top_p[rows, slot][:, None])
        return out

    def _layer_weights(self, i):
        raw = layer_weights(self.s, i, self.seed, self.device)
        p = f"model.layers.{i}."
        f32 = lambda n: raw[n].to(torch.float32)
        W = {"q": q4j(raw[p + "self_attn.q_proj.weight"]),
             "k": q4j(raw[p + "self_attn.k_proj.weight"]),
             "v": q4j(raw[p + "self_attn.v_proj.weight"]),
             "o": q4j(raw[p + "self_attn.o_proj.weight"]),
             "ln1": f32(p + "input_layernorm.weight"),
             "ln2": f32(p + "post_attention_layernorm.weight")}
        if self.s.E:
            W["router"] = f32(p + "block_sparse_moe.gate.weight").t()
            ep = p + "block_sparse_moe.experts."
            W["experts"] = [(q4j(raw[f"{ep}{e}.w1.weight"]),
                             q4j(raw[f"{ep}{e}.w3.weight"]),
                             q4j(raw[f"{ep}{e}.w2.weight"]))
                            for e in range(self.s.E)]
        else:
            W["mlp"] = (q4j(raw[p + "mlp.gate_proj.weight"]),
                        q4j(raw[p + "mlp.up_proj.weight"]),
                        q4j(raw[p + "mlp.down_proj.weight"]))
        return W

    # -- the forward ------------------------------------------------------
    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               positions: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """For each sequence, the float32 logits [len(pos), V] at its
        ``positions`` (the logits row at position t predicts token t+1)."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(seqs, positions)
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = old

    def _logits(self, seqs, positions):
        dev = self.device
        top = top_weights(self.s, self.seed, dev)
        emb = top["model.embed_tokens.weight"]
        hs = [emb[torch.as_tensor(list(t), device=dev)].to(torch.float32)
              for t in seqs]
        head = q4j(top["lm_head.weight"])
        final = top["model.norm.weight"].to(torch.float32)
        del top, emb
        for i in range(self.s.L):
            W = self._layer_weights(i)
            for j, h in enumerate(hs):
                h = h + self._attn(self._norm(h, W["ln1"]), W, j)
                x = self._norm(h, W["ln2"])
                h = h + (self._moe(x, W, j) if self.s.E
                         else self._mlp(x, *W["mlp"], j))
                hs[j] = h
            del W
        out = []
        for j, (h, pos) in enumerate(zip(hs, positions)):
            x = self._norm(h[torch.as_tensor(list(pos), device=dev)], final)
            if self.act_bits and self.low_from is not None:
                lo = torch.as_tensor(list(pos), device=dev) >= self.low_from[j]
                x = torch.where(lo[:, None], fake_int(x, self.act_bits, GROUP),
                                x)
            elif self.act_bits:
                x = fake_int(x, self.act_bits, GROUP)
            out.append(x @ head)
        return out


def first_tokens(low_rows: torch.Tensor, masked: Sequence[int] = ()):
    """The token a (lower-precision) forward puts first at each position."""
    low = low_rows.clone()
    if masked:
        low[:, list(masked)] = float("-inf")
    return low.argmax(dim=-1).tolist()


def gaps(ref_rows: torch.Tensor, tokens: Sequence[int],
         masked: Sequence[int] = ()) -> torch.Tensor:
    """At each position, the gap by which the token's reference logit lies
    below the reference's best over the tokens that could be served
    (``masked`` ids excluded, as the served path excludes them)."""
    r = ref_rows.clone()
    if masked:
        r[:, list(masked)] = float("-inf")
    t = torch.as_tensor(list(tokens), device=r.device)
    return r.max(dim=-1).values - r.gather(1, t[:, None])[:, 0]


def widest_gap(ref_rows, tokens, masked=()) -> float:
    return float(gaps(ref_rows, tokens, masked).max())


def numbers(pairs) -> dict:
    """The compared numbers over (reference rows, served tokens, masked)
    of every sampled request: the widest gap, the median gap, and the
    share of positions whose token is not the reference's best."""
    g = [gaps(r, t, m) for r, t, m in pairs]
    if not g:               # nothing served to judge: fails every limit
        return {"max_gap": 1e9, "median_gap": 1e9, "miss_share": 1.0}
    g = torch.cat(g)
    return {"max_gap": float(g.max()), "median_gap": float(g.median()),
            "miss_share": float((g > 0).float().mean())}
