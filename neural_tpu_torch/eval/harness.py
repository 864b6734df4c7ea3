"""Task-accuracy evaluation: loglikelihood scoring and the lm-eval adapter
(reference scripts/accuracy.py, scripts/ns_evaluator.py:53).

- ``loglikelihood`` / ``score_choices``: standalone multiple-choice scoring
  (HellaSwag/ARC/PIQA-style tasks without lm-eval);
- ``make_lm_eval_model``: an ``lm_eval.api.model.LM`` over a port
  ``Model``, when lm-eval is installed (an optional dependency, as in the
  reference).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..runtime.generate import batch_logits


def loglikelihood(params, cfg, context_ids: Sequence[int],
                  continuation_ids: Sequence[int]) -> Tuple[float, bool]:
    """(sum log p(continuation | context), is_greedy): the lm-eval
    loglikelihood contract."""
    ids = list(context_ids) + list(continuation_ids)
    logits = batch_logits(params, cfg, np.asarray([ids], np.int64))[0]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1) \
        .cpu().numpy()
    start = len(context_ids) - 1
    total, greedy = 0.0, True
    for i, tok in enumerate(continuation_ids):
        row = logp[start + i]
        total += float(row[tok])
        greedy &= int(row.argmax()) == tok
    return total, greedy


def score_choices(params, cfg, context_ids: Sequence[int],
                  choices: Sequence[Sequence[int]],
                  length_normalize: bool = True) -> int:
    """The multiple-choice answer's index by (length-normalized)
    continuation loglikelihood (lm-eval's multiple_choice metric)."""
    scores = []
    for ch in choices:
        ll, _ = loglikelihood(params, cfg, context_ids, ch)
        scores.append(ll / (len(ch) if length_normalize else 1.0))
    return int(np.argmax(scores))


def make_lm_eval_model(model_api, batch_size: int = 1):
    """→ an lm_eval LM over a port ``Model`` (needs the optional lm-eval
    package, as the reference's ns_evaluator does)."""
    try:
        from lm_eval.api.model import LM
    except ImportError as e:
        raise ImportError(
            "lm-eval is not installed; install lm-eval to use the harness "
            "adapter (standalone scoring: eval.harness.loglikelihood / "
            "score_choices)") from e

    class NeuralTpuLM(LM):
        def __init__(self):
            super().__init__()
            self.m = model_api

        def _enc(self, s):
            return self.m.tokenizer.encode(s)

        def loglikelihood(self, requests):
            out = []
            for req in requests:
                ctx, cont = req.args
                ctx_ids = self._enc(ctx) if ctx else [self.m.cfg.bos_token_id]
                cont_ids = self._enc(ctx + cont)[len(ctx_ids):]
                out.append(loglikelihood(self.m.params, self.m.cfg,
                                         ctx_ids, cont_ids))
            return out

        def loglikelihood_rolling(self, requests):
            out = []
            for req in requests:
                (text,) = req.args
                ids = self._enc(text)
                ll, _ = loglikelihood(self.m.params, self.m.cfg,
                                      ids[:1], ids[1:])
                out.append((ll,))
            return out

        def generate_until(self, requests):
            out = []
            for req in requests:
                ctx, gen_kwargs = req.args
                ids = self._enc(ctx)
                res = self.m.generate(
                    [ids],
                    max_new_tokens=gen_kwargs.get("max_gen_toks", 128),
                    do_sample=gen_kwargs.get("do_sample", False),
                    temperature=gen_kwargs.get("temperature", 0.8))[0]
                text = self.m.tokenizer.decode(res[len(ids):])
                for stop in gen_kwargs.get("until", []):
                    text = text.split(stop)[0]
                out.append(text)
            return out

    return NeuralTpuLM()
