"""Sliding-window perplexity (reference scripts/perplexity.py:58).

PPL over a long token stream with a fixed context window and stride:
windows of ``ctx_size`` tokens, scored on the last ``stride`` positions
(teacher-forced, ``runtime.generate.batch_logits``), exp of the mean NLL.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.config import ModelConfig
from ..runtime.generate import batch_logits


def perplexity(params, cfg: ModelConfig, token_ids: Sequence[int],
               ctx_size: int = 512, stride: Optional[int] = None,
               batch: int = 1) -> dict:
    """Returns {"ppl", "nll", "n_tokens", "per_window"}.

    ``batch`` windows go through one [batch, ctx] teacher-forced eval. The
    last eval pads by repeating its final window; the padded rows are
    dropped, so the results do not depend on the batch size.
    """
    ids = np.asarray(token_ids, np.int64)
    stride = stride or ctx_size // 2
    batch = max(1, int(batch))
    n = len(ids)
    if n <= ctx_size:
        raise ValueError("need more tokens than the context window")

    starts = list(range(0, n - ctx_size + 1, stride))
    windows = np.stack([ids[s:s + ctx_size] for s in starts])  # [W, ctx]

    total_nll, total_cnt = 0.0, 0
    per_window: List[float] = []
    for i in range(0, len(starts), batch):
        chunk = windows[i:i + batch]
        nb = len(chunk)
        if nb < batch:       # pad with the last window (one batch shape)
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch - nb, axis=0)])
        logits = batch_logits(params, cfg, chunk)              # [B, T, V]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        targets = torch.as_tensor(chunk[:, 1:]).to(logp.device)
        nll_all = -logp[:, :-1].gather(-1, targets[:, :, None])[:, :, 0] \
            .cpu().numpy()                                     # [B, T-1]
        for j in range(nb):
            # score only the last `stride` targets (except the first
            # window, which scores everything, as the reference does)
            scored = nll_all[j] if i + j == 0 else nll_all[j][-stride:]
            total_nll += float(scored.sum())
            total_cnt += len(scored)
            per_window.append(float(np.exp(scored.mean())))
    return {"ppl": float(np.exp(total_nll / total_cnt)),
            "nll": total_nll / total_cnt, "n_tokens": total_cnt,
            "per_window": per_window}
