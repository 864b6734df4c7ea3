"""output_tok_s: Output tokens made inside the window over the window's
seconds."""


def read(rec, ctx, folder):
    if rec["window_elapsed"] <= 0:
        return None
    return rec["tokens_in_window"] / rec["window_elapsed"]
