"""pickup_ms_p90.tok_s: The 90th percentile of the server's pick-up
(``Sequence.receive_time``, set when the worker takes the request) minus
the due time (ms)."""
from benchmark.readers import p90


def read(rec, ctx, folder):
    v = [(r["receive"] - r["due"]) * 1e3 for r in rec["requests"]
         if r.get("receive") is not None]
    return p90(v) if v else None
