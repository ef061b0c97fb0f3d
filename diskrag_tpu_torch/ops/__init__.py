"""Distances, the fused flat scan (kernels B1, B4) and the flat index."""
