"""k2_svd_fallbacks_per_call: the bonds whose certified truncation (K2)
did not certify and took the exact SVD instead
(``trunc_step_gemm_exact.svd_fallbacks``), per call of the window; read
where K2 ran (``gemm_exact_kernel.launches``, printed beside it)."""

import sys


def read(run):
    c = run.counters
    launches = c.get("gemm_exact_kernel.launches", 0)
    if not launches or not run.calls:
        return None
    print(f"perfbench: K2 launches {launches} over {run.calls} calls, svd "
          f"fallbacks {c['trunc_step_gemm_exact.svd_fallbacks']}",
          file=sys.stderr)
    return c["trunc_step_gemm_exact.svd_fallbacks"] / run.calls
