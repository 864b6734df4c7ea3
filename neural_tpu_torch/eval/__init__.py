"""Evaluation of the port's decoders: sliding-window perplexity, the
lm-eval loglikelihood contract and its adapter, and logits diffs against
a reference model (the port's copy of ``neural_tpu/eval``)."""
from .diff import compare_vs_hf, logits_diff
from .harness import loglikelihood, make_lm_eval_model, score_choices
from .perplexity import perplexity

__all__ = ["perplexity", "logits_diff", "compare_vs_hf", "loglikelihood",
           "score_choices", "make_lm_eval_model"]
