"""Matmul-only probe of the packed scans (counterpart of `_mm_only` /
`mm_only` in `benchmarks/fused_scan_micro.py`).

The probe takes the packed scans' operands (int8 query codes and int8 row
codes from `quantize_int8_global`), runs the scans' whole product and
leaves the fold out. With the queries zero-padded to a multiple of the
query block QB = min(qb, max(128, ceil128(B))) and the rows zero-padded
to a multiple of `tile`,

    out[b, c] = sum over tiles t of  q[b] . db[t * tile + c]     (c < nb_out)

in wrapping int32, rows of the query pad included: the JAX call's
result. The hand-written CUDA kernel M1 (`csrc/mm_probe.cu`) carries it
on the card behind `mm_probe`; its time, taken from a packed scan's time
at the same shapes, is what the fold costs.

**Keeping every product alive.** On the TPU the full [QB, tile] product
runs on the matrix unit and only its first `nb_out` columns are kept. A
CUDA compiler removes products whose results are never read, so a port
that stored only those columns would do `nb_out / tile` of the work. The
port therefore returns a second output,

    rowsum[b] = sum over ALL rows r of  q[b] . db[r]              (int32, wrapping)

into which the kernel adds every accumulator of every tile. It equals
q[b] . colsum(db) mod 2^32, which the plain version computes
independently, so the check that the whole product ran is itself held
bit for bit. The operation count for the kernel's bound is the full
2 * Bpad * Npad * D.

`tile` is an argument because it defines the function (which rows share
an output column), not because any block of the CUDA kernel has that
size. `mm_probe` runs the kernel for CUDA tensors (or raises) and the
plain version `mm_probe_ref` only for CPU tensors, and counts the kernel's
launches in `mm_probe.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from diskrag_tpu_torch.kernels import _build
from diskrag_tpu_torch.ops.flat_scan import _PACKED_MAX_DIM, _match_width, align_code_rows

_TARGET_BLOCKS = 1024  # tiles are cut into parts until the grid has about this many blocks


def padded_queries(b: int, qb: int = 1024) -> int:
    """Rows of the probe's output for a batch of `b`: the batch padded to a
    multiple of QB = min(qb, max(128, ceil128(b))), the JAX call's rule."""
    qb = min(qb, max(128, -(-b // 128) * 128))
    return -(-b // qb) * qb


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 as two's-complement wrap-around (what int32
    accumulation gives), spelled out so that no cast's overflow rule is
    relied on."""
    return (torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)


def _check(q: torch.Tensor, db: torch.Tensor, tile: int, nb_out: int) -> None:
    if q.dtype != torch.int8 or db.dtype != torch.int8:
        raise TypeError(f"the probe takes int8 queries and int8 rows, got {q.dtype}/{db.dtype}")
    if q.ndim != 2 or db.ndim != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"the probe takes [B, D] queries and [N, D] rows, got "
                         f"{tuple(q.shape)} / {tuple(db.shape)}")
    if nb_out <= 0 or tile < nb_out:
        raise ValueError(f"tile ({tile}) must be at least nb_out ({nb_out}), and nb_out positive")


def mm_probe_ref(
    q: torch.Tensor, db: torch.Tensor, *, tile: int, nb_out: int = 512, qb: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of M1: (out [Bpad, nb_out] int32, rowsum
    [Bpad] int32). The int8 products are taken in float64, which is exact
    (|q . v| <= 128^2 * D stays far below 2^53), summed over the tiles in
    int64 and wrapped to int32 at the end, which equals wrapping at every
    add. The rows are walked in chunks of whole tiles."""
    _check(q, db, tile, nb_out)
    b, d = q.shape
    n = db.shape[0]
    dev = q.device
    bpad = padded_queries(b, qb)
    out = torch.zeros((bpad, nb_out), dtype=torch.int64, device=dev)
    qf = q.to(torch.float64)
    n_tiles = -(-n // tile)
    chunk = max(1, (1 << 26) // max(1, b * tile))  # tiles per step
    for t0 in range(0, n_tiles, chunk):
        t1 = min(n_tiles, t0 + chunk)
        blk = db[t0 * tile : min(n, t1 * tile)]
        cross = (qf @ blk.to(torch.float64).T).to(torch.int64)
        tail = (t1 - t0) * tile - blk.shape[0]
        if tail:
            cross = torch.nn.functional.pad(cross, (0, tail))
        out[:b] += cross.view(b, t1 - t0, tile)[:, :, :nb_out].sum(1)
    rowsum = torch.zeros((bpad,), dtype=torch.int64, device=dev)
    rowsum[:b] = (q.to(torch.int64) * db.sum(0, dtype=torch.int64)[None, :]).sum(1)
    return _wrap_int32(out), _wrap_int32(rowsum)


_PROBE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p])


def _probe_cuda(q, db, tile, nb_out, qb):
    if not (db.is_cuda and db.device == q.device):
        raise ValueError("M1: queries and rows must be on one CUDA device")
    if q.shape[1] > _PACKED_MAX_DIM:
        raise ValueError(f"M1 runs the packed scans' product, which caps D at {_PACKED_MAX_DIM}; "
                         f"got D={q.shape[1]}")
    if tile % 16:
        raise ValueError(f"M1 takes a tile that is a multiple of 16 rows, got {tile}")
    b = q.shape[0]
    n = db.shape[0]
    dev = q.device
    bpad = padded_queries(b, qb)
    out = torch.zeros((bpad, nb_out), dtype=torch.int32, device=dev)
    rowsum = torch.zeros((bpad,), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out, rowsum
    if q.shape[1] % 16:  # rows a caller did not align: a copy per call
        db = align_code_rows(db)
        q = _match_width(q, db)
    q, db = q.contiguous(), db.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    if db.data_ptr() % 16:
        db = db.clone()
    row_bytes = q.shape[1]
    lib = _build.load("mm_probe")
    fn = lib.mm_probe_launch
    fn.argtypes = _PROBE_ARGTYPES
    fn.restype = ctypes.c_int
    base = -(-b // lib.mm_probe_block_queries(row_bytes)) * (tile // lib.mm_probe_block_lanes())
    n_tiles = -(-n // tile)
    n_parts = max(1, min(n_tiles, -(-_TARGET_BLOCKS // base)))
    tiles_per_part = -(-n_tiles // n_parts)
    n_parts = -(-n_tiles // tiles_per_part)
    err = fn(q.data_ptr(), db.data_ptr(), b, row_bytes, n, tile, n_tiles, tiles_per_part,
             n_parts, nb_out, out.data_ptr(), rowsum.data_ptr(),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    mm_probe.launches += 1
    _build.check(err, "mm_probe_launch")
    return out, rowsum


def mm_probe(
    q: torch.Tensor, db: torch.Tensor, *, tile: int, nb_out: int = 512, qb: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Matmul-only probe (M1): int8 queries [B, D] and int8 rows [N, D] ->
    (out [Bpad, nb_out] int32, rowsum [Bpad] int32), see the module's
    docstring. `out` is the JAX call's result; `rowsum` is the checked
    output that keeps the products of every column alive. CUDA tensors go
    to the kernel (or raise); CPU tensors to the plain version."""
    if q.is_cuda:
        _check(q, db, tile, nb_out)
        return _probe_cuda(q, db, tile, nb_out, qb)
    return mm_probe_ref(q, db, tile=tile, nb_out=nb_out, qb=qb)


mm_probe.launches = 0


def reset_launch_counts() -> None:
    mm_probe.launches = 0
