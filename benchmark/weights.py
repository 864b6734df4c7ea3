"""Seeded weights of a configuration, under their Hugging Face names.

Each layer's matrices are drawn in one call, ``torch.randn`` in bf16 on the
device from a generator seeded by (seed, layer), and scaled by 0.02 in
bf16: the served type, made where it is served. The program receives them
through its public conversion entry (``convert.build_params``, as a state
dict that draws a layer when its first tensor is asked for); the plain
reference draws the same tensors again from the same seed. Norm weights are
ones, as in a freshly initialised Hugging Face model.

This module imports torch only, so the reference may use it.
"""
from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Dict, List, Tuple

import torch

STD = 0.02


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one draw, from the run's seed (any size) and a
    tag."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


class Shapes:
    """The Hugging Face tensor names and shapes ([out, in]) of a Mistral or
    Mixtral ``config.json``."""

    def __init__(self, hf: dict):
        self.D = hf["hidden_size"]
        self.L = hf["num_hidden_layers"]
        self.H = hf["num_attention_heads"]
        self.Hkv = hf.get("num_key_value_heads") or self.H
        self.Dh = hf.get("head_dim") or self.D // self.H
        self.F = hf["intermediate_size"]
        self.V = hf["vocab_size"]
        self.E = hf.get("num_local_experts", 0) or 0
        self.k = hf.get("num_experts_per_tok", 0) or 0

    def layer(self, i: int) -> List[Tuple[str, tuple]]:
        """The random matrices of layer ``i``, in draw order."""
        p = f"model.layers.{i}."
        D, F, qd, kd = self.D, self.F, self.H * self.Dh, self.Hkv * self.Dh
        out = [(p + "self_attn.q_proj.weight", (qd, D)),
               (p + "self_attn.k_proj.weight", (kd, D)),
               (p + "self_attn.v_proj.weight", (kd, D)),
               (p + "self_attn.o_proj.weight", (D, qd))]
        if self.E:
            out.append((p + "block_sparse_moe.gate.weight", (self.E, D)))
            for e in range(self.E):
                ep = p + f"block_sparse_moe.experts.{e}."
                out += [(ep + "w1.weight", (F, D)), (ep + "w2.weight", (D, F)),
                        (ep + "w3.weight", (F, D))]
        else:
            out += [(p + "mlp.gate_proj.weight", (F, D)),
                    (p + "mlp.up_proj.weight", (F, D)),
                    (p + "mlp.down_proj.weight", (D, F))]
        return out

    def layer_norms(self, i: int) -> List[Tuple[str, tuple]]:
        p = f"model.layers.{i}."
        return [(p + "input_layernorm.weight", (self.D,)),
                (p + "post_attention_layernorm.weight", (self.D,))]

    def top(self) -> List[Tuple[str, tuple]]:
        return [("model.embed_tokens.weight", (self.V, self.D)),
                ("lm_head.weight", (self.V, self.D))]


def draw(entries: List[Tuple[str, tuple]], seed: int, tag: str,
         device) -> Dict[str, torch.Tensor]:
    """One bf16 draw for all of ``entries``, split into views by name."""
    n = sum(_numel(s) for _, s in entries)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    flat = torch.randn(n, generator=g, device=device, dtype=torch.bfloat16)
    flat.mul_(STD)
    out, o = {}, 0
    for name, shape in entries:
        k = _numel(shape)
        out[name] = flat[o:o + k].view(shape)
        o += k
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def layer_weights(shapes: Shapes, i: int, seed: int, device):
    ws = draw(shapes.layer(i), seed, f"layer{i}", device)
    for name, shape in shapes.layer_norms(i):
        ws[name] = torch.ones(shape, dtype=torch.bfloat16, device=device)
    return ws


def top_weights(shapes: Shapes, seed: int, device):
    ws = draw(shapes.top(), seed, "top", device)
    ws["model.norm.weight"] = torch.ones(shapes.D, dtype=torch.bfloat16,
                                         device=device)
    return ws


class LazyStateDict(Mapping):
    """A state dict whose tensors are drawn a layer at a time, when the
    first tensor of that layer is read; only the current layer's draw is
    held."""

    def __init__(self, hf: dict, seed: int, device):
        self.shapes = Shapes(hf)
        self.seed, self.device = seed, device
        self._names = {}
        for i in range(self.shapes.L):
            for name, _ in self.shapes.layer(i) + self.shapes.layer_norms(i):
                self._names[name] = i
        for name, _ in self.shapes.top():
            self._names[name] = "top"
        self._names["model.norm.weight"] = "top"
        self._key, self._held = None, {}

    def __getitem__(self, name):
        key = self._names[name]
        if key != self._key:
            self._held = {}
            self._held = top_weights(self.shapes, self.seed, self.device) \
                if key == "top" else \
                layer_weights(self.shapes, key, self.seed, self.device)
            self._key = key
        return self._held[name]

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def release(self):
        self._key, self._held = None, {}
