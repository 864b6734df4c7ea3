"""step_ms.tok_s: Mean host-clock time of one ``scheduler.step`` call over
the window's calls (ms)."""


def read(rec, ctx, folder):
    st = rec.get("steps") or []
    if not st:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in st) / len(st)
