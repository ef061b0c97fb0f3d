"""Peaks of one NVIDIA H100 (SXM, dense, at the 700 W power limit) and the
least time a kernel could take at its shapes.

The bound functions are copies of `chip_smoke.py::b1_bound_ms` and
`::b4_bound_ms`, so that the benchmark's yardstick cannot move with the
program. A roofline share is the summed bounds over the measured device
time; it is never clamped.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def b1_bound_ms(b: int, n: int, d: int, nb: int) -> tuple[float, str]:
    """Least time for B1's int8 work over the n valid rows: the products
    (2 ops per multiply-add) at the int8 tensor-core peak, or each input
    byte read once (codes, the two norm-block rows, query codes and
    scales) and each output byte written once ([B, NB] vals + ids) at HBM
    bandwidth, the larger."""
    t_ops = 2.0 * b * n * d / PEAK_INT8_OPS
    nbytes = n * d + n * 8 + b * d + b * 4 + b * nb * 8
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def b4_bound_ms(b: int, nb: int, kk: int) -> tuple[float, str]:
    """Least time for B4's work: read the [B, NB] block once, write the
    [B, kk] lanes once; one f32 compare per input element."""
    t_bytes = (b * nb * 4 + b * kk * 4) / PEAK_BYTES
    t_ops = b * nb / PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


# What `graph/knn_build.py::build_vamana_knn` hands B1 and B4 in its flat
# kNN pass at its defaults: query blocks of 4096 database rows, each
# scanned against the whole table at NB = 4096 buckets, then cut to
# kk = 4 * (knn_k + 1) lanes with knn_k = max(64, 4 R / 3).
KNN_QUERY_BLOCK = 4096
KNN_BUCKETS = 4096


def knn_params(n: int, degree_bound: int) -> tuple[list[int], int, int]:
    """(query rows of each launch, knn_k, kk) of the kNN pass over n points."""
    rows = [min(KNN_QUERY_BLOCK, n - i) for i in range(0, n, KNN_QUERY_BLOCK)]
    knn_k = min(max(64, (4 * degree_bound) // 3), n - 1)
    return rows, knn_k, 4 * (knn_k + 1)
