"""Distances, top-k primitives, the fused flat scans (kernels B1-B4, B6), the
flat index and the gathered ADC lookup (kernel B5)."""
