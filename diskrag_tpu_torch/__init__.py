"""diskrag_tpu_torch — the PyTorch/CUDA port of diskrag_tpu.

Serves the Vamana graph (kNN-based build, exact and PQ-guided traversal),
the flat (exhaustive) index and the IVF-Flat index on an NVIDIA Hopper card through
hand-written CUDA kernels (`csrc/`), from the CLI or over HTTP, with the
JAX package's on-disk formats, entry points and results. It imports torch, never jax, and
nothing of `diskrag_tpu`.

Layer map, mirroring the JAX package:

    interfaces     cli.py, api.py
    orchestration  engine.py, build_index.py, convert.py
    measurement    benchmark.py, tools/, utils/profiling.py
    data           data/
    index          index/persist.py, index/ivf.py, index/host_tier.py
    graph          graph/knn_build.py, graph/checkpoint.py, graph/prune.py,
                   graph/search.py
    pq             pq/kmeans.py, pq/product_quantizer.py, pq/residual.py
    ops            ops/distance.py, ops/flat.py, ops/flat_scan.py,
                   ops/topk.py, ops/medoid.py, ops/pq_scan.py,
                   ops/mm_probe.py
    kernels        csrc/*.cu, built at first use by kernels/_build.py;
                   launch counters in kernels/launches.py
    device         device.py (explicit device, cuda by default)
"""

from diskrag_tpu_torch import device as _device  # noqa: F401  (pins f32 matmuls)

__version__ = "0.1.0"
__all__ = ["__version__"]
