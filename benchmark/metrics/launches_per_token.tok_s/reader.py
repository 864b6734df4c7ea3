"""launches_per_token.tok_s: The port's kernel launches in the traced span
(``ops/_cuda.py launch_counts()``, the C entry points named in
``entries/*.txt``; branch and route counts left out) over the tokens
made in it."""
from benchmark.readers import patterns


def read(rec, ctx, folder):
    launches = rec.get("launches")
    toks = sum(s.get("made", 1) for s in rec.get("span_steps") or [])
    if not launches or not toks:
        return None
    names = set(patterns(folder, "entries"))
    n = sum(v for k, v in launches.items() if "+" not in k and k in names)
    return n / toks if n else None
