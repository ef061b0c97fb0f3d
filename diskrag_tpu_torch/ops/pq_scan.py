"""Gathered ADC lookup for PQ-guided traversal (counterpart of
`diskrag_tpu/ops/pq_scan.py`).

    out[b, c] = sum_{j<m} T[b, j, code[b, c, j]]

for per-query tables T [B, m, 256] f32 and per-query gathered candidate
codes [B, C, m] uint8. The hand-written CUDA kernel B5
(`csrc/adc_lookup.cu`) carries it on the card behind
`adc_lookup_gathered_kernel` (the JAX package's
`adc_lookup_gathered_pallas`): the table staged in shared memory, one
thread per candidate adding the m entries in subspace order. The plain
version `adc_lookup_gathered_ref` adds in the same order, so the two are
bit-identical; the wrapper takes it only for CPU tensors and counts the
kernel's launches in `adc_lookup_gathered_kernel.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from diskrag_tpu_torch.kernels import _build

N_CENTROIDS = 256
_MAX_SMEM_BYTES = 227 * 1024  # a block's shared memory on sm_90


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


_ADC_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _adc_cuda(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    if tables.dtype != torch.float32 or tables.ndim != 3 or tables.shape[2] != N_CENTROIDS:
        raise ValueError(f"B5 takes f32 tables [B, m, {N_CENTROIDS}], got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    if codes.dtype != torch.uint8 or codes.ndim != 3:
        raise TypeError(f"B5 takes uint8 codes [B, C, m], got {codes.dtype} {tuple(codes.shape)}")
    b, m, _ = tables.shape
    if codes.shape[0] != b or codes.shape[2] != m:
        raise ValueError(f"B5: codes {tuple(codes.shape)} do not match tables {tuple(tables.shape)}")
    if not (codes.is_cuda and codes.device == tables.device):
        raise ValueError("B5: tables and codes must be on one CUDA device")
    if not (tables.is_contiguous() and codes.is_contiguous()):
        raise ValueError("B5 takes contiguous tables and codes")
    if tables.data_ptr() % 16:
        raise ValueError("B5 takes tables aligned to 16 bytes")
    if m * N_CENTROIDS * 4 > _MAX_SMEM_BYTES:
        raise RuntimeError(
            f"B5: a query's table (m={m}, {m} KB) does not fit a block's "
            f"{_MAX_SMEM_BYTES // 1024} KB of shared memory")
    c = codes.shape[1]
    dev = tables.device
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return out
    fn = _build.load("adc_lookup").adc_lookup_launch
    fn.argtypes = _ADC_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(tables.data_ptr(), codes.data_ptr(), b, c, m, out.data_ptr(),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    adc_lookup_gathered_kernel.launches += 1
    _build.check(err, "adc_lookup_launch")
    return out


def adc_lookup_gathered_kernel(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Gathered ADC lookup (B5): tables [B, m, 256] f32, codes [B, C, m]
    uint8 -> [B, C] f32. CUDA tensors go to the kernel (or raise); CPU
    tensors to the plain version."""
    if tables.is_cuda:
        return _adc_cuda(tables, codes)
    return adc_lookup_gathered_ref(tables, codes)


adc_lookup_gathered_kernel.launches = 0


def reset_launch_counts() -> None:
    adc_lookup_gathered_kernel.launches = 0
