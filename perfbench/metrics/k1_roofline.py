"""k1_roofline: K1 (``csrc/df_matvec.cu``, the double-word f32 matrix
vector product of the df refinement residuals) against its roofline, in
percent.

The work, from shapes: K1 computes the residual products of the solve's
largest local systems, m = rank * n * rank rows and columns (the interior
sites).  One product reads the df matrix (hi and lo, m^2 float32 each)
and the df vector and writes the df result: (2 m^2 + 4 m) * 4 bytes; it
takes 21 FP32 operations an element (df_mul: 3 multiplies, an FMA counted
2, 2 adds, fast_two_sum's 3; df_add: two_sum's 6, 2 adds, fast_two_sum's
3), 21 m^2 in all.  Each launch found by the kernel name is one such
product; their least times are summed and set over their device time.
"""

from perfbench.roofline import kernel_time, least_s, share

KERNEL = "df_matvec_kernel"
OPS_PER_ELEMENT = 21


def read(run):
    launches, spent = kernel_time(run, KERNEL)
    if not launches:
        return None
    cfg = run.config
    m = cfg["rank"] * cfg["n"] * cfg["rank"]
    one = least_s((2 * m * m + 4 * m) * 4, OPS_PER_ELEMENT * m * m, "float32")
    return share(launches * one, spent)
