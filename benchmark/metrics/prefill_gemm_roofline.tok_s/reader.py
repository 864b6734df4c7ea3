"""prefill_gemm_roofline.tok_s: Needed work of the traced span's prompt
products over the device time of the kernel families
(``families/*.txt``) that ran them (%)."""
from benchmark.readers import family_share


def read(rec, ctx, folder):
    return family_share(rec, ctx, folder, "prefill")
