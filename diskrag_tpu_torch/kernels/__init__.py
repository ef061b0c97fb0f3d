"""Build-at-first-use loader for the port's hand-written CUDA kernels
(`csrc/*.cu`); the wrappers live beside their plain versions in `ops/`."""
