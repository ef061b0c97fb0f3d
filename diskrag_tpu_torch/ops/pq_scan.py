"""ADC lookup for PQ-guided traversal (counterpart of
`diskrag_tpu/ops/pq_scan.py`).

    out[b, c] = sum_{j<m} T[b, j, code[b, c, j]]

for per-query tables T [B, m, 256] f32 and per-query gathered candidate
codes [B, C, m] uint8. The hand-written CUDA kernel B5
(`csrc/adc_lookup.cu`) carries it on the card in two addressing modes:

- `adc_lookup_gathered_kernel(tables, codes)`: the JAX package's
  `adc_lookup_gathered_pallas`, the codes gathered by the caller.
- `adc_lookup_ids_kernel(tables, code_table, ids, ...)`: the codes read by
  candidate id from the [N, m] code table, and for a residual PQ the
  query-cell term and the point bias added after the lookup, in that
  order: a traversal round's whole distance step in one launch.

Both add the m entries in subspace order with one rounding per add, as the
plain versions `adc_lookup_gathered_ref` and `adc_lookup_ids_ref` do, so
kernel and plain version are bit-identical. A wrapper takes the plain
version only for CPU tensors; both count the kernel's launches in
`adc_lookup_gathered_kernel.launches` (kernel id B5).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diskrag_tpu_torch.kernels import _build
from diskrag_tpu_torch.kernels.launches import count

N_CENTROIDS = 256


def adc_lookup_gathered_ref(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B5: tables [B, m, 256] f32, codes
    [B, C, m] uint8/int -> [B, C] f32, accumulated over j = 0 .. m-1 in
    that order with one rounding per add (the kernel's order)."""
    b, m, _ = tables.shape
    idx = codes.long()
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32, device=tables.device)
    for j in range(m):
        acc = acc + torch.gather(tables[:, j, :], 1, idx[:, :, j])
    return acc


def adc_lookup_ids_ref(
    tables: torch.Tensor,
    code_table: torch.Tensor,
    ids: torch.Tensor,
    *,
    point_cell: torch.Tensor | None = None,
    point_bias: torch.Tensor | None = None,
    cell_tables: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of B5's by-id mode: the codes of
    clamp(ids, 0, N - 1) gathered from `code_table` [N, m], looked up as
    `adc_lookup_gathered_ref` does, then, for a residual PQ,
    `+ cell_tables[b, point_cell[id]]` and then `+ point_bias[id]`: the
    order of the traversal's distance step in both packages."""
    safe = torch.clamp(ids, 0, code_table.shape[0] - 1).long()
    d = adc_lookup_gathered_ref(tables, code_table[safe])
    if point_cell is not None:
        d = d + torch.gather(cell_tables, 1, point_cell[safe].long()) + point_bias[safe]
    return d


_ADC_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _launcher():
    """The C launcher, its argument types set once (a traversal round calls
    it, and the round's host path is its cost)."""
    fn = _build.load("adc_lookup").adc_lookup_launch
    fn.argtypes = _ADC_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_tables(tables: torch.Tensor) -> None:
    if tables.dtype != torch.float32 or tables.ndim != 3 or tables.shape[2] != N_CENTROIDS:
        raise ValueError(f"B5 takes f32 tables [B, m, {N_CENTROIDS}], got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    if not tables.is_contiguous():
        raise ValueError("B5 takes contiguous tables")


def _adc_cuda(tables, codes, c, *, n=0, ids=None, point_cell=None, point_bias=None,
              cell_tables=None) -> torch.Tensor:
    """Launch B5 (both modes) on the kernel's contract."""
    b, m, _ = tables.shape
    dev = tables.device
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return out
    fn = _launcher()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    n_cells = 0 if cell_tables is None else cell_tables.shape[1]
    err = fn(tables.data_ptr(), codes.data_ptr(), n, ptr(ids), ptr(point_cell), ptr(point_bias),
             ptr(cell_tables), n_cells, b, c, m, out.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    count(adc_lookup_gathered_kernel)
    _build.check(err, "adc_lookup_launch")
    return out


def adc_lookup_gathered_kernel(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Gathered ADC lookup (B5): tables [B, m, 256] f32, codes [B, C, m]
    uint8 -> [B, C] f32. CUDA tensors go to the kernel (or raise); CPU
    tensors to the plain version."""
    if not tables.is_cuda:
        return adc_lookup_gathered_ref(tables, codes)
    _check_tables(tables)
    if codes.dtype != torch.uint8 or codes.ndim != 3:
        raise TypeError(f"B5 takes uint8 codes [B, C, m], got {codes.dtype} {tuple(codes.shape)}")
    b, m, _ = tables.shape
    if codes.shape[0] != b or codes.shape[2] != m:
        raise ValueError(f"B5: codes {tuple(codes.shape)} do not match tables {tuple(tables.shape)}")
    if not (codes.is_cuda and codes.device == tables.device):
        raise ValueError("B5: tables and codes must be on one CUDA device")
    if not codes.is_contiguous():
        raise ValueError("B5 takes contiguous tables and codes")
    return _adc_cuda(tables, codes, codes.shape[1])


def adc_lookup_ids_kernel(
    tables: torch.Tensor,
    code_table: torch.Tensor,
    ids: torch.Tensor,
    *,
    point_cell: torch.Tensor | None = None,
    point_bias: torch.Tensor | None = None,
    cell_tables: torch.Tensor | None = None,
) -> torch.Tensor:
    """B5 by id: tables [B, m, 256] f32, code_table [N, m] uint8, ids
    [B, C] int64 (clamped to [0, N) here as in `adc_lookup_ids_ref`) ->
    [B, C] f32; with a residual PQ's point_cell [N] int32, point_bias [N]
    f32 and cell_tables [B, n_cells] f32 (all three or none) the cell
    term and the bias are added after the lookup. CUDA tensors go to the
    kernel (or raise); CPU tensors to the plain version."""
    aux = (point_cell, point_bias, cell_tables)
    if any(a is not None for a in aux) and any(a is None for a in aux):
        raise ValueError("point_cell/point_bias/cell_tables must be given together")
    if not tables.is_cuda:
        return adc_lookup_ids_ref(tables, code_table, ids, point_cell=point_cell,
                                  point_bias=point_bias, cell_tables=cell_tables)
    _check_tables(tables)
    b, m, _ = tables.shape
    if code_table.dtype != torch.uint8 or code_table.ndim != 2 or code_table.shape[1] != m:
        raise TypeError(f"B5 takes a uint8 code table [N, {m}], got {code_table.dtype} "
                        f"{tuple(code_table.shape)}")
    if ids.dtype != torch.int64 or ids.ndim != 2 or ids.shape[0] != b:
        raise TypeError(f"B5 takes int64 ids [{b}, C], got {ids.dtype} {tuple(ids.shape)}")
    n = code_table.shape[0]
    want = [(code_table, torch.uint8, (n, m)), (ids, torch.int64, tuple(ids.shape))]
    if point_cell is not None:
        want += [(point_cell, torch.int32, (n,)), (point_bias, torch.float32, (n,)),
                 (cell_tables, torch.float32, (b, cell_tables.shape[-1]))]
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"B5 by id: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not (t.is_cuda and t.device == tables.device):
            raise ValueError("B5: every operand must be on the tables' CUDA device")
        if not t.is_contiguous():
            raise ValueError("B5 takes contiguous operands")
    if n == 0:
        raise ValueError("B5 by id: an empty code table")
    return _adc_cuda(tables, code_table, ids.shape[1], n=n, ids=ids, point_cell=point_cell,
                     point_bias=point_bias, cell_tables=cell_tables)


adc_lookup_gathered_kernel.launches = 0


def reset_launch_counts() -> None:
    adc_lookup_gathered_kernel.launches = 0
