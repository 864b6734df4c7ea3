"""Logits diff against a reference model (reference scripts/cal_diff.py).

Cosine similarity and MSE between the port's logits and a reference's
(an HF torch model, duck-typed: called on a [1, T] id tensor, its output's
``.logits``), over a prompt set: the quantization-accuracy smoke gate.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def logits_diff(our_logits: np.ndarray, ref_logits: np.ndarray) -> dict:
    a = np.asarray(our_logits, np.float32)
    b = np.asarray(ref_logits, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"logits of shapes {a.shape} and {b.shape}")
    flat_a = a.reshape(-1, a.shape[-1])
    flat_b = b.reshape(-1, b.shape[-1])
    cos = np.sum(flat_a * flat_b, -1) / (
        np.linalg.norm(flat_a, axis=-1) * np.linalg.norm(flat_b, axis=-1)
        + 1e-9)
    mse = float(np.mean((flat_a - flat_b) ** 2))
    return {"cos_mean": float(cos.mean()), "cos_min": float(cos.min()),
            "mse": mse,
            "argmax_agree": float((flat_a.argmax(-1) ==
                                   flat_b.argmax(-1)).mean())}


def compare_vs_hf(model_api, hf_model, prompts: Sequence[Sequence[int]]):
    """``model_api`` (a port ``Model``: ``model_api([ids])`` gives f32
    logits) against ``hf_model`` over ``prompts``; the mean of each
    :func:`logits_diff` metric, and each prompt's under ``per_prompt``."""
    results = []
    for p in prompts:
        ours = model_api([list(p)])
        with torch.no_grad():
            ref = hf_model(torch.tensor([list(p)])).logits
        results.append(logits_diff(
            ours, ref.detach().to(torch.float32).cpu().numpy()))
    agg = {k: float(np.mean([r[k] for r in results])) for k in results[0]}
    agg["per_prompt"] = results
    return agg
