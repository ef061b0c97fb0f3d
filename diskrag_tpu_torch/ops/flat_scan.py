"""Fused exhaustive scan + candidate cut + exact rerank (counterpart of the
per-row part of `diskrag_tpu/ops/flat_scan_pallas.py`).

Two hand-written CUDA kernels carry this module on the card:

  B1 `csrc/flat_scan.cu` behind `scan_bucketed_topk`: scores q . db
     (int8 x int8 with per-query x per-row scales, or bf16), subtracts the
     L2 norm, and keeps per bucket lane (column j belongs to bucket
     j % NB) the best score and its earliest segment;
  B4 `csrc/topk_lanes.cu` behind `topk_lanes`: the exact top-kk lanes of
     the [B, NB] bucket block, lowest lane on ties, sentinel NB once a row
     runs out of finite lanes.

Each wrapper runs its kernel for CUDA tensors (or raises) and its plain
PyTorch version (`scan_bucketed_topk_ref`, `topk_lanes_ref`) only for CPU
tensors; `chip_smoke.py` holds each kernel against its plain version on
the card. Each wrapper counts its launches in `<wrapper>.launches`.

Scores are similarities (maximized): L2 uses 2*q.v - ||v||^2 with the
factor 2 pre-folded (into the row scales for int8, into the bf16 query
copy otherwise); cosine and dot use q.v and mask pad rows (+inf norm) to
-inf.
"""

from __future__ import annotations

import ctypes

import torch

from diskrag_tpu_torch.kernels import _build
from diskrag_tpu_torch.ops.distance import Metric, brute_force_topk, rerank_exact_topk

NEG_INF = float("-inf")

# The JAX package sizes its Pallas blocks for a TPU's 16 MB scoped VMEM
# and serves by exact brute force when no block fits (see
# `flat_search_fused`). These are its defaults; the port's kernels do
# not use them as tile sizes.
_TPU_QUERY_BLOCK = 1024
_TPU_DB_TILE = 2048


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 quantization over the last axis: codes
    [..., D] int8 and dequant scales [...] f32 (x ~= codes * scales).
    Multiplies by the reciprocal, rounds half to even, clips, casts — the
    JAX package's order, so codes and scales are bit-identical."""
    x = x.to(torch.float32)
    s = torch.amax(torch.abs(x), dim=-1) / 127.0
    pos = s > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, s, torch.ones_like(s)), torch.zeros_like(s))
    codes = torch.clamp(torch.round(x * inv[..., None]), -127, 127).to(torch.int8)
    return codes, s


def build_rowscan_table(
    scan_src: torch.Tensor, *, metric: str = "l2", granule: int = 4096
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Pre-padded per-row int8 scan table: (codes [Npad, D] int8, norm
    block [2, Npad] f32, scales [N] f32, n logical rows). Row 0 holds the
    squared norms (+inf at pads, the scan's padding mask), row 1 the
    dequant scales, pre-doubled for L2, 0 at pads. Same layout as the JAX
    package's table, so either package's table serves in the other."""
    l2 = Metric(metric) == Metric.L2
    n, d = scan_src.shape
    codes, scales = quantize_int8(scan_src)
    src = scan_src.to(torch.float32)
    norms = torch.sum(src * src, dim=-1)
    pad = (-n) % granule
    dev = scan_src.device
    codes = torch.cat([codes, torch.zeros((pad, d), dtype=torch.int8, device=dev)])
    row0 = torch.cat([norms, torch.full((pad,), torch.inf, device=dev)])
    row1 = torch.cat([scales * 2.0 if l2 else scales, torch.zeros((pad,), device=dev)])
    return codes, torch.stack([row0, row1]), scales, n


# --- B1: the bucketed scan ---------------------------------------------------


def scan_bucketed_topk_ref(
    q: torch.Tensor,
    db: torch.Tensor,
    norm_block: torch.Tensor,
    nb: int,
    use_norms: bool,
    q_scales: torch.Tensor | None,
    n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B1 on the kernel's own contract: `q` int8
    or bf16 (already doubled for bf16 L2), `db` [R, D] with the norm block
    [1 or 2, R]; returns (vals [B, nb] f32, ids [B, nb] int32).

    The int8 cross product is taken in float64, which is exact here
    (|q . v| <= 127^2 * D stays far below 2^53), then rounded to f32 as
    the kernel's int32 -> f32 conversion rounds it; the scores follow in
    the kernel's order ((cross * q_scale) * row1) - row0, one rounding per
    operation. The database is walked in chunks of whole segments, each
    folded into the running state with a strict '>', so the earliest
    segment wins as in the sequential fold."""
    int8 = q.dtype == torch.int8
    b = q.shape[0]
    rows = db.shape[0]
    dev = q.device
    best_v = torch.full((b, nb), NEG_INF, dtype=torch.float32, device=dev)
    best_s = torch.full((b, nb), -1, dtype=torch.int64, device=dev)
    n_seg = -(-rows // nb)
    chunk = max(1, (1 << 25) // max(1, b * nb))  # segments per step
    qf = q.to(torch.float64) if int8 else q.to(torch.float32)
    for s0 in range(0, n_seg, chunk):
        r0, r1 = s0 * nb, min(rows, (s0 + chunk) * nb)
        blk = db[r0:r1]
        if int8:
            cross = (qf @ blk.to(torch.float64).T).to(torch.float32)
            cross = cross * q_scales[:, None] * norm_block[1, r0:r1][None, :]
        else:
            cross = qf @ blk.to(torch.float32).T
        nrm = norm_block[0, r0:r1][None, :]
        if use_norms:
            score = cross - nrm
        else:
            score = torch.where(torch.isinf(nrm), NEG_INF, cross)
        segs = -(-(r1 - r0) // nb)
        tail = segs * nb - (r1 - r0)
        if tail:
            score = torch.nn.functional.pad(score, (0, tail), value=NEG_INF)
        score = score.view(b, segs, nb)
        m = torch.amax(score, dim=1)
        iota = torch.arange(segs, device=dev)[None, :, None]
        first = torch.amin(torch.where(score == m[:, None, :], iota, segs), dim=1)
        upd = m > best_v
        best_v = torch.where(upd, m, best_v)
        best_s = torch.where(upd, first + s0, best_s)
    ids = best_s * nb + torch.arange(nb, device=dev)[None, :]
    ids = torch.where((best_s < 0) | (ids >= n), -1, ids)
    return best_v, ids.to(torch.int32)


_SCAN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_void_p,
]


def _scan_cuda(q, db, norm_block, nb, use_norms, q_scales, n):
    int8 = q.dtype == torch.int8
    if db.dtype != q.dtype or q.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"B1 takes int8 or bf16 queries and rows of the same type, got {q.dtype}/{db.dtype}")
    if not (db.is_cuda and norm_block.is_cuda and db.device == q.device == norm_block.device):
        raise ValueError("B1: queries, rows and norm block must be on one CUDA device")
    if norm_block.dtype != torch.float32 or norm_block.shape[1] != db.shape[0]:
        raise ValueError("B1: norm block must be f32 [R, rows]")
    if int8 and (norm_block.shape[0] < 2 or q_scales is None):
        raise ValueError("B1 int8 needs q_scales and a [2, rows] norm block")
    b, d = q.shape
    rows = db.shape[0]
    dev = q.device
    vals = torch.empty((b, nb), dtype=torch.float32, device=dev)
    ids = torch.empty((b, nb), dtype=torch.int32, device=dev)
    if b == 0 or rows == 0:
        return vals.fill_(NEG_INF), ids.fill_(-1)
    esize = q.element_size()
    if (d * esize) % 16:  # rows are read 16 bytes at a time: zero-pad D
        extra = (-(d * esize) % 16) // esize
        q = torch.nn.functional.pad(q, (0, extra))
        db = torch.nn.functional.pad(db, (0, extra))
        d += extra
    q, db, norm_block = q.contiguous(), db.contiguous(), norm_block.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    if db.data_ptr() % 16:
        db = db.clone()
    row_bytes = d * esize
    lib = _build.load("flat_scan")
    fn = lib.flat_scan_launch
    fn.argtypes = _SCAN_ARGTYPES
    fn.restype = ctypes.c_int
    bq, lanes = lib.flat_scan_block_queries(), lib.flat_scan_block_lanes()
    n_seg = -(-rows // nb)
    base = -(-b // bq) * -(-nb // lanes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = max(1, min(n_seg, -(-sms * 8 // base)))
    seg_per_split = -(-n_seg // n_split)
    n_split = -(-n_seg // seg_per_split)
    part_v = torch.empty((n_split, b, nb), dtype=torch.float32, device=dev)
    part_s = torch.empty((n_split, b, nb), dtype=torch.int32, device=dev)
    qs = q_scales.to(torch.float32).contiguous() if int8 else vals
    err = fn(
        q.data_ptr(), qs.data_ptr(), db.data_ptr(), norm_block.data_ptr(),
        b, row_bytes // 4, rows, nb, n, int(int8), int(use_norms),
        seg_per_split, n_split,
        part_v.data_ptr(), part_s.data_ptr(), vals.data_ptr(), ids.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    scan_bucketed_topk.launches += 1
    _build.check(err, "flat_scan_launch")
    return vals, ids


def scan_bucketed_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    *,
    n_buckets: int = 512,
    use_norms: bool = True,
    q_scales: torch.Tensor | None = None,
    db_scales: torch.Tensor | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan (B1): returns (scores [B, NB] f32, ids [B, NB] int32),
    the JAX function's contract (`flat_scan_pallas.py:113`).

    int8 mode: int8 queries/rows plus `q_scales` [B] and `db_scales` [N].
    With `n_valid` the rows are a pre-padded table from
    `build_rowscan_table` and `db_norms` its [2, Npad] norm block (row 1
    already doubled for L2). NB halves down to 128 for databases smaller
    than it. Pad rows carry +inf norms and lose every comparison, so the
    scan needs no padding of its own."""
    args = _scan_operands(queries, db, db_norms, n_buckets=n_buckets, use_norms=use_norms,
                          q_scales=q_scales, db_scales=db_scales, n_valid=n_valid)
    if queries.is_cuda:
        return _scan_cuda(*args)
    return scan_bucketed_topk_ref(*args)


scan_bucketed_topk.launches = 0


def _scan_operands(queries, db, db_norms, *, n_buckets, use_norms, q_scales, db_scales, n_valid):
    """`scan_bucketed_topk`'s arguments in the kernel's own contract:
    (q, db, norm block, nb, use_norms, q_scales, n), the positional
    arguments of `scan_bucketed_topk_ref` and of the kernel's launcher."""
    n = n_valid if n_valid is not None else db.shape[0]
    int8 = queries.dtype == torch.int8
    if int8 and (q_scales is None or (db_scales is None and n_valid is None)):
        raise ValueError("int8 scan needs q_scales and db_scales")
    nb = n_buckets
    while nb > 128 and nb > n:
        nb //= 2
    q = queries
    if use_norms and not int8:
        q = q + q  # fold L2's 2*q.v into the query copy (exact in bf16)
    if n_valid is not None:
        block = db_norms if db_norms.ndim == 2 else db_norms[None, :]
    elif int8:
        scales = db_scales * 2.0 if use_norms else db_scales
        block = torch.stack([db_norms.to(torch.float32), scales.to(torch.float32)])
    else:
        block = db_norms[None, :]
    return q, db, block.to(torch.float32), nb, use_norms, q_scales, n


# --- B4: the candidate cut ---------------------------------------------------


def topk_lanes_ref(scores: torch.Tensor, kk: int) -> torch.Tensor:
    """Plain PyTorch version of B4: exact top-kk lanes of `scores` [B, NB]
    in descending score order, lowest lane on ties (a stable sort gives
    the iterative extraction's order), sentinel NB for -inf lanes."""
    b, nb = scores.shape
    vals, lanes = torch.sort(scores, dim=1, descending=True, stable=True)
    take = min(kk, nb)
    lanes = torch.where(vals[:, :take] == NEG_INF, nb, lanes[:, :take])
    if kk > nb:
        lanes = torch.nn.functional.pad(lanes, (0, kk - nb), value=nb)
    return lanes.to(torch.int32)


_CUT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def topk_lanes(scores: torch.Tensor, kk: int) -> torch.Tensor:
    """Candidate cut (B4): [B, NB] f32 -> [B, kk] int32 lane indices,
    the contract of the JAX `topk_lanes_pallas` (`flat_scan_pallas.py:1278`)."""
    if not scores.is_cuda:
        return topk_lanes_ref(scores, kk)
    if scores.dtype != torch.float32 or scores.ndim != 2:
        raise ValueError("B4 takes a [B, NB] f32 block")
    scores = scores.contiguous()
    b, nb = scores.shape
    dev = scores.device
    out = torch.empty((b, kk), dtype=torch.int32, device=dev)
    fn = _build.load("topk_lanes").topk_lanes_launch
    fn.argtypes = _CUT_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(scores.data_ptr(), b, nb, kk, out.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    topk_lanes.launches += 1
    _build.check(err, "topk_lanes_launch")
    return out


topk_lanes.launches = 0


def reset_launch_counts() -> None:
    scan_bucketed_topk.launches = 0
    topk_lanes.launches = 0


# --- the per-row fused search ---------------------------------------------


def _fit_query_block(
    query_block: int, db_tile: int, n_buckets: int, d: int,
    *, state_bytes: int, itemsize: int, norm_rows: int = 1,
    batch: int | None = None,
) -> int:
    """The JAX package's VMEM fit (`flat_scan_pallas.py:741`): the largest
    query block whose working set fits a TPU's 16 MB scoped VMEM, 0 when
    none does. Kept only for the brute-force rule in `flat_search_fused`."""
    in_tile_bytes = 2 * (db_tile * d * itemsize + norm_rows * db_tile * 4)
    budget = (15 << 20) - in_tile_bytes
    if budget <= 0:
        return 0
    row1 = db_tile * 4 + n_buckets * state_bytes
    qb1 = min(query_block, budget // row1 // 8 * 8)
    if qb1 >= 8 and batch is not None and batch <= qb1:
        return qb1
    row2 = db_tile * 4 + 2 * n_buckets * state_bytes
    qb2 = min(query_block, budget // row2 // 8 * 8)
    return 0 if qb2 < 8 else qb2


def _rerank(queries, vectors_f32, scores, ids, k, kk, m):
    """Candidate cut (B4) + exact f32 rerank. Rows with fewer finite
    lanes than kk carry the sentinel NB, mapped to id -1 rather than a
    second copy of a winner."""
    nb = scores.shape[1]
    kk = min(kk, nb)
    take = topk_lanes(scores, kk).long()
    dead = take >= nb
    cand = torch.where(dead, -1, torch.gather(ids, 1, torch.where(dead, 0, take)))
    return rerank_exact_topk(queries, vectors_f32, cand, k, m)


def flat_search_fused(
    queries: torch.Tensor,
    vectors_q: torch.Tensor,
    norms_sq: torch.Tensor,
    vectors_f32: torch.Tensor,
    *,
    k: int,
    metric: str = "l2",
    n_buckets: int = 512,
    rerank_mult: int = 4,
    db_scales: torch.Tensor | None = None,
    rerank_width: int | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive top-k through the fused scan (B1), the cut (B4) and an
    exact f32 rerank: (dists [B, k] ascending, ids [B, k]). The per-row
    branch of the JAX function (`flat_scan_pallas.py:1049`); the rules
    that change results come across unchanged:

      - NB widens with k until the bucket-collision bound holds;
      - exact brute force when k exceeds the effective NB (tiny DBs);
      - exact brute force when no TPU query block fits 16 MB of VMEM;
      - kk = max(rerank_mult*k, 32), or the pinned `rerank_width`.

    int8: `vectors_q` holds int8 codes with `db_scales` (or, with
    `n_valid`, the pre-padded table and its [2, Npad] norm block in the
    `norms_sq` position). bf16: `vectors_q` is the bf16 scan copy.
    Cosine expects the scan copy pre-normalized (FlatIndex does that)."""
    m = Metric(metric)
    b, d = queries.shape
    n = n_valid if n_valid is not None else vectors_q.shape[0]
    int8 = vectors_q.dtype == torch.int8
    if n_valid is not None and (not int8 or norms_sq.ndim != 2):
        raise ValueError(
            "n_valid with the per-row path needs int8 codes plus the "
            "[2, Npad] norm block from build_rowscan_table"
        )
    while n_buckets < min(50 * (k - 1), 1 << 15):
        n_buckets *= 2
    eff_nb = n_buckets
    while eff_nb > 128 and eff_nb > n:
        eff_nb //= 2
    if k > eff_nb:
        return brute_force_topk(queries, vectors_f32, k, metric)
    kk = max(rerank_mult * k, 32) if rerank_width is None else max(rerank_width, k)
    db_tile = max(_TPU_DB_TILE, n_buckets)
    # A TPU rule, kept only so the port returns what the JAX package
    # returns: where no Pallas query block fits the 16 MB scoped VMEM
    # (large k at large D), the JAX package serves by exact brute force.
    fit = _fit_query_block(
        _TPU_QUERY_BLOCK, db_tile, n_buckets, d, state_bytes=8,
        itemsize=1 if int8 else 2, norm_rows=2 if int8 else 1, batch=b,
    )
    if fit == 0:
        return brute_force_topk(queries, vectors_f32, k, metric)
    if m == Metric.COSINE:
        qn = torch.sqrt(torch.sum(queries * queries, -1, keepdim=True)) + 1e-12
        qf = queries / qn
        use_norms = False
    else:
        qf = queries
        use_norms = m == Metric.L2
    if int8:
        qb, q_scales = quantize_int8(qf)
    else:
        qb, q_scales = qf.to(torch.bfloat16), None
    scores, ids = scan_bucketed_topk(
        qb, vectors_q, norms_sq, n_buckets=n_buckets, use_norms=use_norms,
        q_scales=q_scales, db_scales=db_scales, n_valid=n_valid,
    )
    return _rerank(queries, vectors_f32, scores, ids, k, kk, m)
