"""Fused exhaustive scans + candidate cut + exact rerank (counterpart of
`diskrag_tpu/ops/flat_scan_pallas.py`).

Hand-written CUDA kernels carry this module on the card:

  B1 `csrc/flat_scan.cu` behind `scan_bucketed_topk`: scores q . db
     (int8 x int8 with per-query x per-row scales, or bf16), subtracts the
     L2 norm, and keeps per bucket lane (column j belongs to bucket
     j % NB) the best score and its earliest segment;
  B4 `csrc/topk_lanes.cu` behind `topk_lanes`: the exact top-kk lanes of
     the [B, NB] bucket block, lowest lane on ties, sentinel NB once a row
     runs out of finite lanes;
  B2 `csrc/packed_scan.cu` behind `scan_bucketed_topk_packed`: int8 L2
     with one scale for the whole database and one per query batch; score
     and segment packed into one int32, p = 512*cross + seg - 256*nint,
     max-folded per bucket lane (the larger segment wins ties);
  B3 `csrc/hier_scan.cu` behind `scan_bucketed_topk_hier`: the B2 fold per
     super-tile of 256 segments with local segment ids, merged across
     super-tiles into (score_int, global segment) with a strict '>' (the
     earlier super-tile wins ties), so NB does not grow with N. B2 and B3
     share one partial kernel (`csrc/packed_wgmma.cuh`: wgmma fed by TMA),
     whose grid `plan_packed_scan` plans;
  B6 the same source, behind `scan_bucketed_topk_hier(pipelined=True)`:
     B3's output from a partial kernel of its own
     (`csrc/pingpong_wgmma.cuh`: a TMA producer warpgroup and two consumer
     warpgroups taking turns on the tensor cores, each folding one segment
     while the other's product runs), whose grid `plan_pipelined_scan`
     plans.

B2 and B3 can fuse the candidate cut (`cut_kk`): the pass that merges the
parallel parts extracts the top-kk element ids from the exact int32 state
and only [B, kk] ids reach PyTorch.

Each wrapper runs its kernel for CUDA tensors (or raises) and its plain
PyTorch version (`*_ref`) only for CPU tensors; `chip_smoke.py` holds each
kernel against its plain version on the card. Each wrapper counts its
launches in `<wrapper>.launches` (B6 in
`scan_bucketed_topk_hier.launches_pipelined`).

Scores are similarities (maximized): L2 uses 2*q.v - ||v||^2 with the
factor 2 pre-folded (into the row scales for per-row int8, into the bf16
query copy, into the packed integer); cosine and dot use q.v on the
per-row path and mask pad rows (+inf norm) to -inf; the packed path serves
cosine as L2 on normalized copies.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from diskrag_tpu_torch.kernels import _build
from diskrag_tpu_torch.kernels.launches import count
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


def align_code_rows(codes: torch.Tensor) -> torch.Tensor:
    """`codes` [R, D] (int8 or bf16) with zero columns appended until a row
    is a whole number of 16 bytes, which is how the kernels read rows. Done
    once where an index is built or loaded (`FlatIndex`), so that no scan
    copies the table; a zero column adds nothing to any product. The
    wrappers widen the query codes to match (`_match_width`)."""
    extra = -(codes.shape[1] * codes.element_size()) % 16 // codes.element_size()
    if extra:
        codes = torch.nn.functional.pad(codes, (0, extra))
    return codes.contiguous()


def _match_width(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """`q` with zero columns appended up to the width of rows that
    `align_code_rows` widened."""
    extra = db.shape[1] - q.shape[1]
    if extra < 0:
        raise ValueError(f"queries are wider ({q.shape[1]}) than the rows ({db.shape[1]})")
    return torch.nn.functional.pad(q, (0, extra)) if extra else q


def _c_function(stem: str, name: str, argtypes: list):
    """`name` of the library built from `csrc/<stem>.cu`, its argument types
    set once (the short kernels' host path is part of their time)."""
    fn = _c_functions.get(name)
    if fn is None:
        fn = getattr(_build.load(stem), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _c_functions[name] = fn
    return fn


_c_functions: dict[str, ctypes._CFuncPtr] = {}


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


# The scan kernel's tiles (`csrc/flat_scan.cu`, both forms; the wrapper
# checks them against the library's exported values): 64 queries per
# consumer warpgroup, one to three warpgroups per block, 64 bucket lanes per
# block, rows in K boxes of 128 bytes, a ring of 4 stages.
_ROWSCAN_WG_QUERIES = 64
_ROWSCAN_MAX_CONSUMERS = 3
_ROWSCAN_LANES = 64
_ROWSCAN_BOX = 128
_ROWSCAN_STAGES = 4
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may opt into


def _rowscan_smem_bytes(n_cons: int, n_kb: int, streamed: bool) -> int:
    """The scan kernel's dynamic shared memory (`scan_smem_bytes` in
    `csrc/flat_scan.cu`): alignment slack, the resident query boxes, the
    ring's stages (a database tile, plus the query tiles when streamed),
    the staged norm rows and the mbarriers."""
    tile = _ROWSCAN_BOX * _ROWSCAN_LANES
    a = 0 if streamed else n_cons * n_kb * tile
    stage = (1 + (n_cons if streamed else 0)) * tile
    return (1024 + a + _ROWSCAN_STAGES * stage + _ROWSCAN_STAGES * 2 * _ROWSCAN_LANES * 4
            + (2 * _ROWSCAN_STAGES + 1) * 8)


@dataclasses.dataclass(frozen=True)
class RowScanPlan:
    """How B1 (int8 or bf16) cuts one call into blocks: `n_cons` consumer
    warpgroups of 64 queries per block, query boxes resident in shared
    memory or `streamed` through the ring, a grid of (query tiles, lane
    tiles, parts), each part `seg_per_split` contiguous segments. The plan
    changes the grid, never the result."""

    n_cons: int
    streamed: bool
    q_tiles: int
    lane_tiles: int
    n_seg: int
    seg_per_split: int
    n_split: int

    @property
    def block_queries(self) -> int:
        return self.n_cons * _ROWSCAN_WG_QUERIES


@functools.lru_cache(maxsize=256)
def plan_rowscan(b: int, nb: int, rows: int, row_bytes: int, sms: int) -> RowScanPlan:
    """B1's grid for `b` queries over `rows` rows of `row_bytes` bytes
    (D for int8, 2 * D for bf16) in buckets of `nb` lanes on a card of `sms`
    SMs (one block an SM). Up to three consumer warpgroups (192 queries)
    per block, as many as the batch fills and as fit their query boxes in
    shared memory beside the ring; the query boxes stream through the ring
    only where even one warpgroup's do not fit. The segments are cut into
    parts when the query x lane tiles are fewer than two blocks an SM:
    between two and eight waves, the count that leaves the last wave
    fullest (the smaller on ties)."""
    n_kb = -(-row_bytes // _ROWSCAN_BOX)
    want = min(_ROWSCAN_MAX_CONSUMERS, -(-b // _ROWSCAN_WG_QUERIES))
    n_cons, streamed = next(
        (c, st) for st in (False, True) for c in range(want, 0, -1)
        if _rowscan_smem_bytes(c, n_kb, st) <= _SMEM_LIMIT)
    q_tiles = -(-b // (n_cons * _ROWSCAN_WG_QUERIES))
    lane_tiles = -(-nb // _ROWSCAN_LANES)
    n_seg = -(-rows // nb)
    base = q_tiles * lane_tiles
    n_split = 1
    if base < 2 * sms:
        best = -1.0
        for n in range(-(-2 * sms // base), -(-8 * sms // base) + 1):
            n = min(n, n_seg)
            blocks = base * n
            eff = blocks / (-(-blocks // sms) * sms)
            if eff > best:
                best, n_split = eff, n
    seg_per_split = -(-n_seg // n_split)
    n_split = -(-n_seg // seg_per_split)
    return RowScanPlan(n_cons, streamed, q_tiles, lane_tiles, n_seg, seg_per_split, n_split)


@functools.cache
def _check_rowscan_tiles() -> None:
    """Once per process: the built kernel's tiles are the planner's."""
    lib = _build.load("flat_scan")
    if (lib.flat_scan_wg_queries(), lib.flat_scan_max_consumers(),
            lib.flat_scan_lanes()) != (_ROWSCAN_WG_QUERIES, _ROWSCAN_MAX_CONSUMERS, _ROWSCAN_LANES):
        raise RuntimeError("B1: the library's tile sizes differ from the wrapper's")


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _tma_norm_rows(block: torch.Tensor) -> torch.Tensor:
    """The norm block's rows 0 and 1 as TMA reads them: rows a multiple of
    16 bytes apart from a 16-byte-aligned base. The pre-padded tables
    already are (4096-row granule); an unpadded [2, N] block is copied into
    one whose rows are widened to a multiple of 4 floats."""
    if block.stride(0) % 4 == 0 and block.stride(1) == 1 and block.data_ptr() % 16 == 0:
        return block
    wide = torch.empty((2, -(-block.shape[1] // 4) * 4), dtype=torch.float32, device=block.device)
    wide[:, : block.shape[1]] = block[:2]
    return wide


_SCAN_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
    ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]


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
    if (d * esize) % 16:  # rows a caller did not align: a copy per call
        db = align_code_rows(db)
        q = _match_width(q, db)
        d = db.shape[1]
    q, db, norm_block = q.contiguous(), db.contiguous(), norm_block.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    if db.data_ptr() % 16:
        db = db.clone()
    row_bytes = d * esize
    _check_rowscan_tiles()
    plan = plan_rowscan(b, nb, rows, row_bytes, _sm_count(dev))
    parts = 0 if plan.n_split == 1 else plan.n_split  # one part writes vals / ids
    part_v = torch.empty((parts, b, nb), dtype=torch.float32, device=dev)
    part_s = torch.empty((parts, b, nb), dtype=torch.int32, device=dev)
    if int8:
        qs = q_scales.to(torch.float32).contiguous()
        norm_block = _tma_norm_rows(norm_block)
        stride = norm_block.stride(0)
    else:  # row 0 alone, read as a vector: no copy, whatever the block's stride
        qs = None
        if norm_block.data_ptr() % 16:
            norm_block = norm_block[:1].clone()
        stride = 0
    fn = _c_function("flat_scan", "flat_scan_launch", _SCAN_ARGTYPES)
    err = fn(0 if int8 else 1, q.data_ptr(), 0 if qs is None else qs.data_ptr(), db.data_ptr(),
             norm_block.data_ptr(), b, row_bytes, rows, stride, nb, n, int(use_norms),
             plan.n_cons, int(plan.streamed), plan.seg_per_split, plan.n_split,
             part_v.data_ptr(), part_s.data_ptr(), vals.data_ptr(), ids.data_ptr(),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    count(scan_bucketed_topk)
    if err == -1:
        raise RuntimeError("flat_scan_launch: the CUDA driver refused a TMA descriptor")
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
    return _match_width(q, db), db, block.to(torch.float32), nb, use_norms, q_scales, n


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


@dataclasses.dataclass(frozen=True)
class CutPlan:
    """How B4 runs one call: threads per block (one block per row), the
    sort's variant (`indirect`: 16-bit lanes read through the keys, where
    64-bit (key, lane) words do not fit beside the row) and the dynamic
    shared memory in bytes."""

    threads: int
    indirect: bool
    smem: int


@functools.lru_cache(maxsize=64)
def plan_cut(nb: int, kk: int) -> CutPlan:
    """B4's launch for [B, nb] scores cut to kk lanes (`csrc/topk_lanes.cu`):
    128 threads a row up to nb = 1024, 256 up to 8192, 512 above; shared
    memory for two 256-bin histograms, the row's keys and the sort's
    places (the next power of two >= min(kk, nb)). Raises where even the
    16-bit sort does not fit."""
    threads = 128 if nb <= 1024 else 256 if nb <= 8192 else 512
    places = 1 << max(0, min(kk, nb) - 1).bit_length()
    base = 2 * 256 * 4 + 4 * (nb + (nb & 1))
    if base + 8 * places <= _SMEM_LIMIT - 1024:
        return CutPlan(threads, False, base + 8 * places)
    if nb < 0xFFFF and base + 2 * places <= _SMEM_LIMIT - 1024:
        return CutPlan(threads, True, base + 2 * places)
    raise ValueError(f"B4: a row of {nb} lanes does not fit a block's shared memory")


_CUT_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def topk_lanes(scores: torch.Tensor, kk: int) -> torch.Tensor:
    """Candidate cut (B4): [B, NB] f32 -> [B, kk] int32 lane indices,
    the contract of the JAX `topk_lanes_pallas` (`flat_scan_pallas.py:1278`)."""
    if not scores.is_cuda:
        return topk_lanes_ref(scores, kk)
    if scores.dtype != torch.float32 or scores.ndim != 2:
        raise ValueError("B4 takes a [B, NB] f32 block")
    scores = scores.contiguous()
    b, nb = scores.shape
    plan = plan_cut(nb, kk)
    dev = scores.device
    out = torch.empty((b, kk), dtype=torch.int32, device=dev)
    fn = _c_function("topk_lanes", "topk_lanes_launch", _CUT_ARGTYPES)
    err = fn(scores.data_ptr(), b, nb, kk, plan.threads, int(plan.indirect), plan.smem,
             out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    count(topk_lanes)
    _build.check(err, "topk_lanes_launch")
    return out


topk_lanes.launches = 0


def reset_launch_counts() -> None:
    scan_bucketed_topk.launches = 0
    topk_lanes.launches = 0
    scan_bucketed_topk_packed.launches = 0
    scan_bucketed_topk_hier.launches = 0
    scan_bucketed_topk_hier.launches_pipelined = 0


# --- geometry rules kept from the reference ------------------------------------


def _fit_query_block(
    query_block: int, db_tile: int, n_buckets: int, d: int,
    *, state_bytes: int, itemsize: int, norm_rows: int = 1,
    batch: int | None = None, scratch_row_bytes: int = 0,
) -> int:
    """The JAX package's VMEM fit (`flat_scan_pallas.py:741`): the largest
    query block whose working set (double-buffered input tiles, the
    [QB, T] score tile, the [QB, NB] state, `scratch_row_bytes` of scratch
    per query row) fits a TPU's 16 MB scoped VMEM, 0 when none does. No
    kernel of the port is tiled by it. It is kept because it decides
    results: the brute-force rule in `flat_search_fused`, and which of
    the two packed folds (B2 or B3) serves a batch (`plan_packed_search`)."""
    in_tile_bytes = 2 * (db_tile * d * itemsize + norm_rows * db_tile * 4)
    budget = (15 << 20) - in_tile_bytes
    if budget <= 0:
        return 0
    row1 = db_tile * 4 + n_buckets * state_bytes + scratch_row_bytes
    qb1 = min(query_block, budget // row1 // 8 * 8)
    if qb1 >= 8 and batch is not None and batch <= qb1:
        return qb1
    row2 = db_tile * 4 + 2 * n_buckets * state_bytes + scratch_row_bytes
    qb2 = min(query_block, budget // row2 // 8 * 8)
    return 0 if qb2 < 8 else qb2


_PACK = 256  # segment ids per packed int32
_PACK_BITS = 8
_INT32_MIN = -(1 << 31)
_EMPTY_HIER = _INT32_MIN >> _PACK_BITS  # below any reachable score_int
# |512*cross| + 256*2^21 + 256 < 2^31 needs |cross| <= 127*127*D with
# D <= 192; past that the packed int32 overflows and corrupts winners.
_PACKED_MAX_DIM = 192


def _cut_scratch_row_bytes(cut_kk: int | None) -> int:
    """The [QB, kkpad] int32 scratch row the reference's fused cut charges
    to the VMEM fit (kkpad = cut_kk rounded up to 128 lanes)."""
    return 0 if cut_kk is None else max(128, -(-cut_kk // 128) * 128) * 4


@functools.lru_cache(maxsize=256)
def _packed_layout(
    n: int, d: int, n_buckets: int, query_block: int, db_tile: int,
    batch: int | None = None, scratch_row_bytes: int = 0,
) -> tuple[int, int, int, int]:
    """The reference's geometry for the flat packed fold
    (`flat_scan_pallas.py:793`): (nb, db_tile, query_block, pad_n). NB is
    the request rounded up to a power of two (>= 128, halved for tiny
    databases) and then doubled until the `n` physical rows (pads
    included) make at most 256 segments; the rows are padded to a
    multiple of the TPU tile. query_block 0 means no TPU block fits: the
    caller routes elsewhere. Only nb, pad_n and "query_block == 0 / is it
    smaller than the batch" decide results."""
    nb = 1 << max(7, (n_buckets - 1).bit_length())
    while nb > 128 and nb > n:
        nb //= 2
    db_tile = max(nb, (min(db_tile, 1 << 20) // nb) * nb)
    db_tile = nb * (1 << (max(1, db_tile // nb).bit_length() - 1))
    pad_n = (-n) % db_tile
    while (n + pad_n) > _PACK * nb:
        nb *= 2
        db_tile = nb * (1 << (max(1, db_tile // nb).bit_length() - 1))
        pad_n = (-n) % db_tile
    query_block = _fit_query_block(
        query_block, db_tile, nb, d, state_bytes=4, itemsize=1,
        batch=batch, scratch_row_bytes=scratch_row_bytes,
    )
    return nb, db_tile, query_block, pad_n


@functools.lru_cache(maxsize=256)
def _hier_layout(
    n_phys: int, n: int, d: int, n_buckets: int, query_block: int, db_tile: int,
    batch: int | None = None, cut_kk: int | None = None, pipelined: bool = False,
) -> tuple[int, int, int, int]:
    """The reference's geometry for the hierarchical fold
    (`flat_scan_pallas.py:608-638`): (nb, db_tile, query_block, pad_n). NB
    is the request rounded up to a power of two, halved while it exceeds
    the `n` logical rows; the TPU tile holds at most 256 segments and the
    `n_phys` physical rows are padded to a multiple of it. Whatever the
    tile, a super-tile is 256 segments (merge_every * tile / nb == 256)."""
    nb = 1 << max(7, (n_buckets - 1).bit_length())
    while nb > 128 and nb > n:
        nb //= 2
    if pipelined:
        db_tile = min(db_tile, 2 * nb)
    db_tile = max(nb, (min(db_tile, 1 << 20) // nb) * nb)
    db_tile = min(db_tile, nb * _PACK)
    db_tile = nb * (1 << (max(1, db_tile // nb).bit_length() - 1))
    pad_n = (-n_phys) % db_tile
    scratch_rb = nb * 4 + (2 * db_tile * 4 if pipelined else 0)
    scratch_rb += _cut_scratch_row_bytes(cut_kk)
    query_block = _fit_query_block(
        query_block, db_tile, nb, d, state_bytes=8, itemsize=1,
        batch=batch, scratch_row_bytes=scratch_rb,
    )
    return nb, db_tile, query_block, pad_n


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """What decides the packed search's results for one call: which fold
    runs ("packed" = B2, "hier" = B3, "brute" = exact brute force), its
    bucket count, the rows it scans (physical rows plus the reference's
    pad rows), the fused cut's width (None = two-stage cut with B4), and
    the TPU tile requests the fold's wrapper derives that geometry from."""

    fold: str
    nb: int = 0
    n_scan: int = 0
    cut_kk: int | None = None
    query_block: int = 0
    db_tile: int = 0


def plan_packed_search(
    n_phys: int, n: int, d: int, b: int, n_buckets: int, kk: int,
) -> PackedPlan:
    """The reference's routing for the packed path
    (`flat_scan_pallas.py:1142-1218`) as plain integer arithmetic. These
    are TPU rules (a 16 MB VMEM fit), kept only so the port returns what
    the JAX package returns; no kernel of the port is tiled by them.
    `n_buckets` is the request after the k-widening, `kk` the rerank
    width, `n_phys` / `n` the table's physical / logical rows.

      - exact brute force where no TPU query block fits at all, where
        the chosen fold's own refit finds none, or where D > 192;
      - the cut is fused when kk <= 64;
      - the flat packed fold (B2) serves when its widened layout still
        fits the whole batch in as few blocks as requested, else the
        hierarchical fold (B3) at the requested NB with the TPU tile
        capped at 4 * n_buckets (which sets its pad rows)."""
    db_tile = max(_TPU_DB_TILE, n_buckets)
    fit = _fit_query_block(_TPU_QUERY_BLOCK, db_tile, n_buckets, d, state_bytes=4,
                           itemsize=1, norm_rows=1, batch=b)
    if fit == 0 or d > _PACKED_MAX_DIM:  # the folds refuse D > 192
        return PackedPlan("brute")
    query_block = max(8, fit)
    cut = kk if kk <= 64 else None
    cut_rb = _cut_scratch_row_bytes(cut)
    nb_flat, _, qb_flat, pad_flat = _packed_layout(
        n_phys, d, n_buckets, query_block, db_tile, batch=b, scratch_row_bytes=cut_rb)
    if qb_flat == 0 or qb_flat < min(b, query_block):
        hier_tile = min(db_tile, 4 * n_buckets)
        nb, _, qb, pad_n = _hier_layout(
            n_phys, n, d, n_buckets, query_block, hier_tile, batch=b, cut_kk=cut)
        if qb == 0:
            return PackedPlan("brute")
        return PackedPlan("hier", nb, n_phys + pad_n, cut, query_block, hier_tile)
    return PackedPlan("packed", nb_flat, n_phys + pad_flat, cut, query_block, db_tile)


def quantize_int8_global(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale for the whole array:
    codes [..., D] int8 and a 0-d f32 scale (1 for an all-zero array).
    Divides by the scale (the per-row `quantize_int8` multiplies by a
    reciprocal), rounds half to even, clips, casts — the JAX package's
    order, so codes and scale are bit-identical."""
    x = x.to(torch.float32)
    s = torch.amax(torch.abs(x)) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    codes = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return codes, s


def build_packed_scan_table(
    scan_src: torch.Tensor, *, granule: int = 4096
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Pre-padded packed-scan table: (codes [Npad, D] int8, nf [1, Npad]
    f32 = squared norms / scale with +inf at pads, scale 0-d f32, n logical
    rows), padded to a multiple of `granule`. Same layout as the JAX
    package's table. Serve it with `flat_search_fused(..., db_nf=nf,
    n_valid=n)`."""
    n, d = scan_src.shape
    codes, scale = quantize_int8_global(scan_src)
    src = scan_src.to(torch.float32)
    norms = torch.sum(src * src, dim=-1)
    pad = (-n) % granule
    dev = scan_src.device
    codes = torch.cat([codes, torch.zeros((pad, d), dtype=torch.int8, device=dev)])
    nf = torch.cat([norms / scale, torch.full((pad,), torch.inf, device=dev)])
    return codes, nf[None, :], scale, n


# --- B2, B3, B6: the packed folds ------------------------------------------------


def _super_tile_maxima(q, db, nf, inv_qs, nb, n_scan):
    """Yields, per super-tile of 256 segments, the max-folded packed state
    [B, nb] int32: packed = 512*cross + (seg & 255) - 256*nint with
    nint = int(clip(round(nf * inv_qs), 0, 2^21)), the product in f32 and
    the clip before the cast. The int8 cross product is taken in float64
    (exact: |cross| <= 127^2 * 192 < 2^53) and everything after it in
    int64, inside int32's range for D <= 192. Rows at or past the table's
    end, up to `n_scan`, are pad rows: zero codes, +inf nf. The table is
    walked in chunks of whole segments that never cross a super-tile."""
    b = q.shape[0]
    n_phys = db.shape[0]
    dev = q.device
    n_seg = n_scan // nb
    qf = q.to(torch.float64)
    chunk = max(1, min(_PACK, (1 << 24) // max(1, b * nb)))
    chunk = 1 << (chunk.bit_length() - 1)  # divides 256
    local = None
    for s0 in range(0, n_seg, chunk):
        s1 = min(n_seg, s0 + chunk)
        r0, r1 = s0 * nb, s1 * nb
        blk = db[r0:min(r1, n_phys)]
        nfc = nf[r0:min(r1, n_phys)]
        tail = (r1 - r0) - blk.shape[0]
        cross = (qf @ blk.to(torch.float64).T).to(torch.int64)
        nint = torch.clamp(torch.round(nfc * inv_qs), 0.0, float(1 << 21)).to(torch.int64)
        if tail:
            cross = torch.nn.functional.pad(cross, (0, tail))
            nint = torch.nn.functional.pad(nint, (0, tail), value=1 << 21)
        seg = (torch.arange(s0, s1, device=dev) & (_PACK - 1)).repeat_interleave(nb)
        p = cross * (2 * _PACK) + (seg - nint * _PACK)[None, :]
        m = torch.amax(p.view(b, s1 - s0, nb), dim=1).to(torch.int32)
        local = m if local is None else torch.maximum(local, m)
        if s1 % _PACK == 0 or s1 == n_seg:
            yield s0 // _PACK, local
            local = None


def epilogue_cut_ids_ref(
    state: torch.Tensor, kk: int, empty: int, n_valid: int,
    gseg: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused cut: top-kk element ids [B, kk]
    int32 from the exact int32 fold state [B, NB], highest value first,
    lowest lane on ties (a stable sort gives the iterative extraction's
    order); id = segment * NB + lane with the segment from the value's low
    8 bits (flat packed state) or from `gseg` (hierarchical state); -1 once
    a row holds only `empty`, and -1 for an id at or past `n_valid` (which
    can sit inside a row)."""
    b, nb = state.shape
    vals, lanes = torch.sort(state, dim=1, descending=True, stable=True)
    take = min(kk, nb)
    vals, lanes = vals[:, :take], lanes[:, :take]
    seg = torch.bitwise_and(vals, _PACK - 1) if gseg is None else torch.gather(gseg, 1, lanes)
    ids = seg.to(torch.int64) * nb + lanes
    ids = torch.where((vals == empty) | (ids >= n_valid), -1, ids)
    if kk > nb:
        ids = torch.nn.functional.pad(ids, (0, kk - nb), value=-1)
    return ids.to(torch.int32)


def scan_bucketed_topk_packed_ref(
    q: torch.Tensor, inv_qs: torch.Tensor, db: torch.Tensor, nf: torch.Tensor,
    nb: int, n_scan: int, n_valid: int, cut_kk: int | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Plain PyTorch version of B2 on the kernel's own contract: `q`
    [B, D] int8, `inv_qs` 0-d f32 = 1 / q_scale, `db` [R, D] int8 with
    `nf` [R] f32, scanned as `n_scan` rows in `n_scan / nb` <= 256
    segments. The fold is a plain max of the packed int32, so the larger
    segment wins ties. Returns (scores [B, nb] f32 = the packed ints cast,
    -inf where empty; ids [B, nb] int32) or, with `cut_kk`, (None, ids
    [B, cut_kk])."""
    if n_scan > _PACK * nb:
        raise ValueError("the flat packed fold holds at most 256 segments")
    b = q.shape[0]
    packed = torch.full((b, nb), _INT32_MIN, dtype=torch.int32, device=q.device)
    for _, local in _super_tile_maxima(q, db, nf, inv_qs, nb, n_scan):
        packed = local
    if cut_kk is not None:
        return None, epilogue_cut_ids_ref(packed, cut_kk, _INT32_MIN, n_valid)
    empty = packed == _INT32_MIN
    seg = torch.bitwise_and(packed, _PACK - 1).to(torch.int64)  # floor mod 256
    ids = seg * nb + torch.arange(nb, device=q.device)[None, :]
    ids = torch.where(empty | (ids >= n_valid), -1, ids).to(torch.int32)
    scores = torch.where(empty, NEG_INF, packed.to(torch.float32))
    return scores, ids


def scan_bucketed_topk_hier_ref(
    q: torch.Tensor, inv_qs: torch.Tensor, db: torch.Tensor, nf: torch.Tensor,
    nb: int, n_scan: int, n_valid: int, cut_kk: int | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Plain PyTorch version of B3 (and of B6, whose output is B3's), on
    the kernel's own contract (see `scan_bucketed_topk_packed_ref`; any
    number of segments). Per super-tile of 256 segments the B2 fold with
    local segment ids; across super-tiles, in order, val = packed >> 8
    (arithmetic) and gseg = 256 * super_tile + (packed & 255) replace the
    running pair where val is strictly larger, so the earlier super-tile
    wins ties. Returns (scores [B, nb] f32 = val cast, -inf where empty;
    ids [B, nb] int32) or, with `cut_kk`, (None, ids [B, cut_kk])."""
    b = q.shape[0]
    dev = q.device
    best_v = torch.full((b, nb), _EMPTY_HIER, dtype=torch.int32, device=dev)
    best_s = torch.full((b, nb), -1, dtype=torch.int32, device=dev)
    for tile, p in _super_tile_maxima(q, db, nf, inv_qs, nb, n_scan):
        val = torch.bitwise_right_shift(p, _PACK_BITS)  # arithmetic on int32
        gseg = tile * _PACK + torch.bitwise_and(p, _PACK - 1)
        upd = (val > best_v) & (p != _INT32_MIN)
        best_v = torch.where(upd, val, best_v)
        best_s = torch.where(upd, gseg, best_s)
    if cut_kk is not None:
        return None, epilogue_cut_ids_ref(best_v, cut_kk, _EMPTY_HIER, n_valid, gseg=best_s)
    ids = best_s.to(torch.int64) * nb + torch.arange(nb, device=dev)[None, :]
    ids = torch.where((best_s < 0) | (ids >= n_valid), -1, ids).to(torch.int32)
    scores = torch.where(best_s < 0, NEG_INF, best_v.to(torch.float32))
    return scores, ids


def _packed_operands(queries_i8, q_scale, db_i8, db_norms, db_scale, n_valid):
    """A packed wrapper's arguments in the kernels' contract: (q, inv_qs
    0-d f32, db, nf [R] f32, n logical rows). With `n_valid` the rows are
    a pre-padded table and `db_norms` its nf row; without, nf =
    db_norms / db_scale is built here."""
    if queries_i8.dtype != torch.int8 or db_i8.dtype != torch.int8:
        raise TypeError("the packed folds take int8 queries and int8 rows")
    if n_valid is not None:
        nf = db_norms.reshape(-1)
        n = n_valid
    else:
        nf = db_norms.to(torch.float32) / db_scale
        n = db_i8.shape[0]
    if nf.shape[0] != db_i8.shape[0]:
        raise ValueError("one nf / norm value per table row is needed")
    inv_qs = (1.0 / torch.as_tensor(q_scale, dtype=torch.float32, device=queries_i8.device))
    return _match_width(queries_i8, db_i8), inv_qs.reshape(()), db_i8, nf.to(torch.float32), n


# The partial kernel of B2 and B3 (`csrc/packed_wgmma.cuh`; the wrapper
# checks these against the library's exported values): a block is one
# warpgroup of 64 queries over 64 bucket lanes, and an SM holds
# `_PACKED_BLOCKS_PER_SM` of them (its launch bound). A part is a power of
# two of segments that divides 256.
_PACKED_QUERIES = 64
_PACKED_LANES = 64
_PACKED_BLOCKS_PER_SM = 3
# The planner's costs, in steps of a block (folding one segment while the
# SM holds its other blocks: about 0.4 us on an H100 at 1000 x 1M, PERF.md):
# a block's fixed cost (the queries into registers, the ring's first fill
# from L2 or memory, its stores: about 4 us), and a part's scratch at the
# card's memory rate: 4 bytes a (query, lane) written, 4 read by the merge,
# and as much again for the merge's loop over the parts. Both fit to the
# part sizes timed in PERF.md.
_BLOCK_STEPS = 10.0
_STEP_SECONDS = 0.4e-6
_PART_BYTES = 16
_PEAK_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class PackedScanPlan:
    """How the partial kernel of B2 and B3 cuts one call into blocks: a
    grid of (query tiles of 64, lane tiles of 64, parts), each part
    `segs_per_part` contiguous segments (a power of two that divides 256,
    so no part crosses a super-tile). The plan changes the grid, never the
    result."""

    q_tiles: int
    lane_tiles: int
    n_seg: int
    segs_per_part: int
    n_parts: int


@functools.lru_cache(maxsize=256)
def plan_packed_scan(b: int, nb: int, n_seg: int, row_bytes: int, sms: int) -> PackedScanPlan:
    """The grid of B2's and B3's partial kernel for `b` queries over
    `n_seg` segments of `nb` lanes, rows of `row_bytes` bytes (a multiple
    of 16, at most 192), on a card of `sms` SMs holding
    `_PACKED_BLOCKS_PER_SM` blocks each. The segments per part are the
    power of two (256 down to 1) that minimises the estimated time: the
    blocks' work (each a part plus a block's fixed cost) spread over the
    SMs' slots, plus one block's length for the last to finish, plus what
    the parts' scratch costs to write and merge (`_BLOCK_STEPS`,
    `_STEP_SECONDS`, `_PART_BYTES`); the larger part on ties."""
    if row_bytes % 16 or not 0 < row_bytes <= _PACKED_MAX_DIM:
        raise ValueError(f"packed scan: rows of {row_bytes} bytes (a multiple of 16, <= 192)")
    if nb % _PACKED_LANES or b <= 0 or sms <= 0:
        raise ValueError(f"packed scan: nb={nb} (a multiple of {_PACKED_LANES}), b={b}, sms={sms}")
    q_tiles = -(-b // _PACKED_QUERIES)
    lane_tiles = nb // _PACKED_LANES
    part_steps = b * nb * _PART_BYTES / _PEAK_BYTES_PER_S / _STEP_SECONDS
    spp, n_parts = _cut_parts(q_tiles * lane_tiles, n_seg, sms * _PACKED_BLOCKS_PER_SM,
                              _BLOCK_STEPS, part_steps)
    return PackedScanPlan(q_tiles, lane_tiles, n_seg, spp, n_parts)


@functools.cache
def _check_tiles(stem: str, prefix: str, want: tuple[int, int, int]) -> None:
    """Once per process and kernel: the built partial kernel's tiles
    (`<prefix>_queries`, `_lanes`, `_blocks_per_sm` of library `stem`) are
    its planner's."""
    lib = _build.load(stem)
    got = tuple(getattr(lib, f"{prefix}_{k}")() for k in ("queries", "lanes", "blocks_per_sm"))
    if got != want:
        raise RuntimeError(f"{prefix}: the library's tiles {got} differ from the wrapper's {want}")


# B6's partial kernel (csrc/pingpong_wgmma.cuh): a block is a producer
# warpgroup and two consumer warpgroups of 64 queries each over 64 bucket
# lanes, two blocks an SM (its launch bound; setmaxnreg hands the consumers
# the producer's registers). Its planner's step is one segment of a block
# (both consumers' products and folds) while the SM holds its other block:
# about 0.6 us on an H100 at 1000 x 1M (PERF.md). Parts of 32 to 256
# segments measured within 4% of each other at 1M, within 20% at 200k.
_PIPE_QUERIES = 128
_PIPE_LANES = 64
_PIPE_BLOCKS_PER_SM = 2
_PIPE_BLOCK_STEPS = 10.0
_PIPE_STEP_SECONDS = 0.6e-6


def _cut_parts(blocks_per_part: int, n_seg: int, slots: int, block_steps: float,
               part_steps: float) -> tuple[int, int]:
    """(segments per part, parts): the power of two (256 down to 1) that
    minimises the estimated time of a grid of `blocks_per_part` blocks a
    part over `slots` block slots: the blocks' work (each a part plus
    `block_steps`) spread over the slots, plus one block's length for the
    last to finish, plus `part_steps` a part for its scratch; the larger
    part on ties."""
    best = None
    spp = min(_PACK, 1 << (max(1, n_seg) - 1).bit_length())
    while spp >= 1:
        n_parts = max(1, -(-n_seg // spp))
        blocks = blocks_per_part * n_parts
        length = min(spp, n_seg) + block_steps
        est = blocks * length / slots + length + part_steps * n_parts
        if best is None or est < best[0]:
            best = (est, spp, n_parts)
        spp //= 2
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def plan_pipelined_scan(b: int, nb: int, n_seg: int, row_bytes: int, sms: int) -> PackedScanPlan:
    """The grid of B6's partial kernel for `b` queries over `n_seg`
    segments of `nb` lanes, rows of `row_bytes` bytes (a multiple of 16, at
    most 192), on a card of `sms` SMs: query tiles of 128, lane tiles of
    64, and the parts `_cut_parts` picks with B6's own costs
    (`_PIPE_BLOCK_STEPS`, `_PIPE_STEP_SECONDS`, `_PIPE_BLOCKS_PER_SM`
    blocks an SM). The plan changes the grid, never the result."""
    if row_bytes % 16 or not 0 < row_bytes <= _PACKED_MAX_DIM:
        raise ValueError(f"pipelined scan: rows of {row_bytes} bytes (a multiple of 16, <= 192)")
    if nb % _PIPE_LANES or b <= 0 or sms <= 0:
        raise ValueError(f"pipelined scan: nb={nb} (a multiple of {_PIPE_LANES}), b={b}, sms={sms}")
    q_tiles = -(-b // _PIPE_QUERIES)
    lane_tiles = nb // _PIPE_LANES
    part_steps = b * nb * _PART_BYTES / _PEAK_BYTES_PER_S / _PIPE_STEP_SECONDS
    spp, n_parts = _cut_parts(q_tiles * lane_tiles, n_seg, sms * _PIPE_BLOCKS_PER_SM,
                              _PIPE_BLOCK_STEPS, part_steps)
    return PackedScanPlan(q_tiles, lane_tiles, n_seg, spp, n_parts)


_PACKED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
_PACKED_TAIL = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _packed_cuda(stem, q, inv_qs, db, nf, nb, n_scan, n_valid, cut_kk, pipelined=False):
    """Launch B2 (`stem` "packed_scan") or B3 / B6 ("hier_scan") on the
    kernels' contract. Allocates the outputs and the parts scratch; B2's
    and B3's grid comes from `plan_packed_scan`, B6's from
    `plan_pipelined_scan`: either changes the grid, never the result."""
    tensors = (q, inv_qs, db, nf)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("packed scan: queries, rows, nf and scale must be on one CUDA device")
    b, d = q.shape
    dev = q.device
    if n_scan % nb or n_scan < db.shape[0]:
        raise ValueError("packed scan: n_scan must cover the table in whole segments")
    if cut_kk is not None:
        state_bytes = nb * 4 * (2 if stem == "hier_scan" else 1)
        if state_bytes > 227 * 1024:
            raise RuntimeError(
                f"fused cut: a [{nb}] int32 state row does not fit a block's shared memory")
        ids = torch.empty((b, cut_kk), dtype=torch.int32, device=dev)
        scores = None
    else:
        ids = torch.empty((b, nb), dtype=torch.int32, device=dev)
        scores = torch.empty((b, nb), dtype=torch.float32, device=dev)
    if b == 0:
        return scores, ids
    if d % 16:  # rows a caller did not align: a copy per call
        db = align_code_rows(db)
        q = _match_width(q, db)
    q, db, nf = q.contiguous(), db.contiguous(), nf.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    if db.data_ptr() % 16:  # TMA reads the rows from a 16-byte-aligned base
        db = db.clone()
    row_bytes = q.shape[1]
    n_seg = n_scan // nb
    hier = stem == "hier_scan"
    if pipelined:
        _check_tiles(stem, "hier_scan_pipelined", (_PIPE_QUERIES, _PIPE_LANES, _PIPE_BLOCKS_PER_SM))
        plan = plan_pipelined_scan(b, nb, n_seg, row_bytes, _sm_count(dev))
    else:
        _check_tiles(stem, stem, (_PACKED_QUERIES, _PACKED_LANES, _PACKED_BLOCKS_PER_SM))
        plan = plan_packed_scan(b, nb, n_seg, row_bytes, _sm_count(dev))
    spp, n_parts = plan.segs_per_part, plan.n_parts
    # one scratch for the parts [n_parts, b, nb] and, 16-byte aligned after
    # them, the partial kernel's per-row term nc [n_scan]
    n_part_ints = -(-n_parts * b * nb // 4) * 4
    scratch = torch.empty(n_part_ints + n_scan, dtype=torch.int32, device=dev)
    argtypes = _PACKED_ARGTYPES + ([ctypes.c_int] if hier else []) + _PACKED_TAIL
    fn = _c_function(stem, f"{stem}_launch", argtypes)
    args = [q.data_ptr(), inv_qs.data_ptr(), db.data_ptr(), nf.data_ptr(),
            b, row_bytes, db.shape[0], n_scan, nb, n_valid, spp, n_parts,
            scratch.data_ptr(), scratch.data_ptr() + 4 * n_part_ints, cut_kk or 0]
    if hier:
        args.append(int(pipelined))
    err = fn(*args, 0 if scores is None else scores.data_ptr(), ids.data_ptr(),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if not hier:
        count(scan_bucketed_topk_packed)
    elif pipelined:
        count(scan_bucketed_topk_hier, "launches_pipelined")
    else:
        count(scan_bucketed_topk_hier)
    if err == -1:
        raise RuntimeError(f"{stem}_launch: the CUDA driver refused a TMA descriptor")
    if err == -2:  # B6 only: checked before anything is launched
        lib = _build.load(stem)
        raise RuntimeError(
            f"{stem}_launch: B6's partial kernel was built with "
            f"{lib.hier_scan_pipelined_kernel_regs(row_bytes)} registers a thread, its "
            f"setmaxnreg split assumes {lib.hier_scan_pipelined_launch_regs()}: refused, "
            "as setmaxnreg.inc would wait forever")
    _build.check(err, f"{stem}_launch")
    return scores, ids


def _check_packed_dim(d: int, what: str) -> None:
    if d > _PACKED_MAX_DIM:
        raise ValueError(
            f"{what} caps D at {_PACKED_MAX_DIM} (int32 range proof); "
            f"got D={d} — use the per-row int8 scan instead"
        )


def scan_bucketed_topk_packed(
    queries_i8: torch.Tensor,
    q_scale: torch.Tensor,
    db_i8: torch.Tensor,
    db_norms: torch.Tensor,
    db_scale: torch.Tensor | None,
    *,
    n_buckets: int = 1024,
    query_block: int = _TPU_QUERY_BLOCK,
    db_tile: int = _TPU_DB_TILE,
    n_valid: int | None = None,
    cut_kk: int | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Fused L2 scan with the packed-int32 fold (B2), the JAX function's
    contract (`flat_scan_pallas.py:832`): int8 queries with one `q_scale`
    for the batch, int8 rows with one `db_scale`, both from
    `quantize_int8_global`; `db_norms` [N] f32 squared norms of the f32
    rows. Returns (scores [B, NB] — the packed ints as f32, order-correct,
    not distances — and ids [B, NB], -1 for empty buckets). NB widens until
    the physical rows make at most 256 segments (`_packed_layout`).

    With `n_valid` the rows are a pre-padded table from
    `build_packed_scan_table` and `db_norms` its nf row. `cut_kk` fuses the
    candidate cut and returns (None, ids [B, cut_kk]). `query_block` and
    `db_tile` are the reference's TPU tile requests: they size no block
    here, but they set NB's widening, the pad rows scanned and the
    ValueError where the reference finds no block that fits."""
    args = _packed_fold_operands(
        queries_i8, q_scale, db_i8, db_norms, db_scale, n_buckets=n_buckets,
        query_block=query_block, db_tile=db_tile, n_valid=n_valid, cut_kk=cut_kk)
    if queries_i8.is_cuda:
        return _packed_cuda("packed_scan", *args)
    return scan_bucketed_topk_packed_ref(*args)


def _packed_fold_operands(queries_i8, q_scale, db_i8, db_norms, db_scale, *, n_buckets,
                          query_block, db_tile, n_valid, cut_kk):
    """`scan_bucketed_topk_packed`'s arguments in the kernel's own contract:
    (q, inv_qs, db, nf, nb, n_scan, n, cut_kk), the positional arguments of
    `scan_bucketed_topk_packed_ref` and of the kernel's launcher."""
    b, d = queries_i8.shape
    _check_packed_dim(d, "packed scan")
    n_phys = db_i8.shape[0]  # physical rows: segment ids must cover pads too
    nb, tile, qb, pad_n = _packed_layout(
        n_phys, d, n_buckets, query_block, db_tile, batch=b,
        scratch_row_bytes=_cut_scratch_row_bytes(cut_kk))
    if qb == 0:
        raise ValueError(
            f"packed scan geometry (N={n_phys}, NB={nb}, T={tile}) exceeds the "
            "reference's scoped-VMEM budget at any query block — use the "
            "per-row int8/bf16 scan for databases this large"
        )
    q, inv_qs, db, nf, n = _packed_operands(queries_i8, q_scale, db_i8, db_norms, db_scale, n_valid)
    return q, inv_qs, db, nf, nb, n_phys + pad_n, n, cut_kk


scan_bucketed_topk_packed.launches = 0


def scan_bucketed_topk_hier(
    queries_i8: torch.Tensor,
    q_scale: torch.Tensor,
    db_i8: torch.Tensor,
    db_norms: torch.Tensor,
    db_scale: torch.Tensor | None,
    *,
    n_buckets: int = 512,
    query_block: int = _TPU_QUERY_BLOCK,
    db_tile: int = _TPU_DB_TILE,
    pipelined: bool = False,
    n_valid: int | None = None,
    cut_kk: int | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Fused L2 scan with the hierarchical packed fold (B3), the JAX
    function's contract (`flat_scan_pallas.py:562`). Same inputs as
    `scan_bucketed_topk_packed`; NB stays at the requested width at any N.
    Returns (scores [B, NB] — integer score units as f32 — and ids
    [B, NB], -1 for empty buckets), or with `cut_kk` (None, ids
    [B, cut_kk]).

    `pipelined` runs B6, the kernel that overlaps one warpgroup's product
    with another's fold (the reference overlaps a tile's product with the
    previous tile's fold); its output is B3's. As in the reference it
    narrows the TPU tile to 2 * NB (which can change the pad rows scanned)
    and rejects `cut_kk`."""
    args = _hier_fold_operands(
        queries_i8, q_scale, db_i8, db_norms, db_scale, n_buckets=n_buckets,
        query_block=query_block, db_tile=db_tile, pipelined=pipelined,
        n_valid=n_valid, cut_kk=cut_kk)
    if queries_i8.is_cuda:
        return _packed_cuda("hier_scan", *args, pipelined=pipelined)
    return scan_bucketed_topk_hier_ref(*args)


def _hier_fold_operands(queries_i8, q_scale, db_i8, db_norms, db_scale, *, n_buckets,
                        query_block, db_tile, pipelined, n_valid, cut_kk):
    """`scan_bucketed_topk_hier`'s arguments in the kernels' own contract
    (see `_packed_fold_operands`)."""
    b, d = queries_i8.shape
    _check_packed_dim(d, "packed folds")
    n_phys = db_i8.shape[0]
    n = n_valid if n_valid is not None else n_phys
    if pipelined and cut_kk is not None:
        raise ValueError("cut_kk is not supported on the pipelined variant")
    nb, tile, qb, pad_n = _hier_layout(
        n_phys, n, d, n_buckets, query_block, db_tile, batch=b, cut_kk=cut_kk,
        pipelined=pipelined)
    if qb == 0:
        raise ValueError(
            f"hier scan geometry (N={n}, NB={nb}, T={tile}) exceeds the "
            "reference's scoped-VMEM budget at any query block"
        )
    q, inv_qs, db, nf, n = _packed_operands(queries_i8, q_scale, db_i8, db_norms, db_scale, n_valid)
    return q, inv_qs, db, nf, nb, n_phys + pad_n, n, cut_kk


scan_bucketed_topk_hier.launches = 0
scan_bucketed_topk_hier.launches_pipelined = 0  # B6


# --- the fused search -------------------------------------------------------------


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
    db_scale_global: torch.Tensor | None = None,
    rerank_width: int | None = None,
    db_nf: torch.Tensor | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive top-k through a fused scan, a candidate cut and an exact
    f32 rerank: (dists [B, k] ascending, ids [B, k]) — the JAX function
    (`flat_scan_pallas.py:1049`). The rules that change results come
    across unchanged:

      - NB widens with k until the bucket-collision bound holds;
      - exact brute force when k exceeds the effective NB (tiny DBs);
      - exact brute force when no TPU query block fits 16 MB of VMEM;
      - kk = max(rerank_mult*k, 32), or the pinned `rerank_width`.

    Per-row int8 (B1 + B4): `vectors_q` holds int8 codes with `db_scales`
    (or, with `n_valid`, the pre-padded table and its [2, Npad] norm block
    in the `norms_sq` position). bf16: `vectors_q` is the bf16 scan copy.
    Cosine expects the scan copy pre-normalized (FlatIndex does that).

    Packed int8 (`db_scale_global` given; l2 and cosine): `vectors_q` holds
    codes from `quantize_int8_global` and `norms_sq` the scan copy's
    squared norms, or with `n_valid` the table of `build_packed_scan_table`
    with its nf row in `db_nf`. The queries take ONE scale for the whole
    batch, so splitting a batch changes ids. `plan_packed_search` picks
    the fold (B2 or B3) and fuses the cut when kk <= 64; wider cuts go
    through the f32 scores and B4."""
    m = Metric(metric)
    b, d = queries.shape
    n_phys = vectors_q.shape[0]
    n = n_valid if n_valid is not None else n_phys
    int8 = vectors_q.dtype == torch.int8
    packed = db_scale_global is not None
    if packed and m == Metric.DOT:
        raise ValueError("the packed-int32 scan supports l2/cosine only")
    if n_valid is not None:
        if packed and db_nf is None:
            raise ValueError(
                "n_valid with the packed path needs db_nf from build_packed_scan_table"
            )
        if not packed and (not int8 or norms_sq.ndim != 2):
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
    if packed:
        return _packed_search(queries, vectors_q, norms_sq, vectors_f32, k, kk, m,
                              n_buckets, db_scale_global, db_nf, n_valid)
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


def _packed_search(queries, codes, norms_sq, vectors_f32, k, kk, m, n_buckets,
                   db_scale_global, db_nf, n_valid):
    """The packed branch of `flat_search_fused`. Cosine rides the L2 fold:
    on a normalized database copy with normalized queries, L2 order is
    cosine order, and the rerank computes the true cosine distances."""
    b, d = queries.shape
    n_phys = codes.shape[0]
    n = n_valid if n_valid is not None else n_phys
    plan = plan_packed_search(n_phys, n, d, b, n_buckets, kk)
    if plan.fold == "brute":
        return brute_force_topk(queries, vectors_f32, k, m)
    if m == Metric.COSINE:
        qf = queries / (torch.linalg.vector_norm(queries, dim=-1, keepdim=True) + 1e-12)
    else:
        qf = queries
    q_i8, q_scale = quantize_int8_global(qf)  # one scale for the whole batch
    # the wrapper rebuilds the plan's geometry from the same tile requests
    # (the plan already applied its "no block fits" rule)
    scan = scan_bucketed_topk_hier if plan.fold == "hier" else scan_bucketed_topk_packed
    scores, ids = scan(
        q_i8, q_scale, codes, db_nf if n_valid is not None else norms_sq,
        db_scale_global, n_buckets=n_buckets, query_block=plan.query_block,
        db_tile=plan.db_tile, n_valid=n_valid, cut_kk=plan.cut_kk)
    if plan.cut_kk is not None:
        return rerank_exact_topk(queries, vectors_f32, ids, k, m)
    return _rerank(queries, vectors_f32, scores, ids, k, kk, m)
