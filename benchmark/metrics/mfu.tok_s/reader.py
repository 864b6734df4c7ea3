"""mfu.tok_s: The whole model step's share of the card's peak: the least
time of the needed work of the window's steps (``roofline.step_least_s``
a step) over the window's seconds on the host clock (%). Read from the
window, never from the profiled span, whose host the profiler slows."""
from benchmark import roofline
from benchmark.readers import kv_bytes


def read(rec, ctx, folder):
    steps = rec.get("steps") or []
    if not steps or rec["window_elapsed"] <= 0:
        return None
    m = roofline.Model(ctx.hf)
    kvb = kv_bytes(ctx.mix)
    need = sum(roofline.step_least_s(m, s, kvb) for s in steps)
    return 100.0 * need / rec["window_elapsed"] if need else None
