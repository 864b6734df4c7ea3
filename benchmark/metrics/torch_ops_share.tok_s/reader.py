"""torch_ops_share.tok_s: Device time of the kernels that are not the
port's own (``port_kernels/ *.txt``) over all kernel time in the traced
span (%)."""
from benchmark.readers import matcher, patterns, traced


def read(rec, ctx, folder):
    if not traced(rec):
        return None
    span = rec["span"]
    port = matcher(patterns(folder, "port_kernels"))
    total = span.kernel_s()
    other = span.kernel_s(lambda n: not port(n))
    return 100.0 * other / total if total > 0 else None
