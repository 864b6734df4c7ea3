"""setup_s: Seconds from the start of set-up (kernel build, weights,
conversion, warm-up) to the start of the window."""


def read(rec, ctx, folder):
    return rec["setup_s"]
