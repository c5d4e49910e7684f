"""k2_roofline: K2 (``csrc/gemm_exact.cu``, ``gemm_exact_grid.cuh``, the
certified truncation of one bond) against its roofline, in percent.

The work, from the rounding's shapes alone: after the left-to-right QR
sweep the input keeps its ranks r_i = min(rank, n^i, n^(d-i)); the
right-to-left sweep meets at site i the (r_i, n * k) matrix, k the rank
already kept to its right, and keeps min(target, r_i, n * k).  A bond
truncates where it keeps less than both sides (for d = 32, rank 256,
target 128: the 17 bonds of (256, 256) kept at 128).  Each such bond reads
its matrix once and writes the kept rows of V^T once (4 bytes an element,
the configuration's float32), and does the operations of one symmetric
Gram of the matrix on the smaller side, counted on and above its diagonal
(s (s + 1) l for an s x l matrix with s <= l), at the FP32 rate.  Nothing
here counts K2's own steps (outer iterations, Newton-Schulz steps), so the
count is the same whatever implements K2.  The least time of a call's
bonds is set over K2's device time per traced call.
"""

from perfbench.roofline import kernel_time, least_s, share

KERNEL = "gemm_exact::"


def truncated_bonds(cfg):
    """(rows, cols, keep) of every bond the rounding truncates."""
    d, n, rank, target = cfg["d"], cfg["n"], cfg["rank"], cfg["target_rank"]
    r = [1] + [min(rank, n ** i, n ** (d - i)) for i in range(1, d)] + [1]
    bonds, k = [], r[d]
    for i in range(d - 1, 0, -1):
        rows, cols = r[i], n * k
        keep = min(target, rows, cols)
        if keep < rows and keep < cols:
            bonds.append((rows, cols, keep))
        k = keep
    return bonds


def least_per_call(cfg) -> float:
    total = 0.0
    for rows, cols, keep in truncated_bonds(cfg):
        s, l = min(rows, cols), max(rows, cols)
        total += least_s((rows * cols + keep * cols) * 4, s * (s + 1) * l,
                         "float32")
    return total


def read(run):
    launches, spent = kernel_time(run, KERNEL)
    if not launches or not run.traced_calls:
        return None
    return share(least_per_call(run.config), spent / run.traced_calls)
