"""The benchmark's inputs, made from `--seed`: the points, the query pool
and each row's text and metadata.

The points follow `diskrag_tpu_torch/benchmark.py::make_dataset` (the JAX
bench's SIFT-like clustered set): `n_clusters` centres drawn N(0, 1) and
scaled by `center_sigma`, each point a centre plus N(0, noise_sigma) noise,
each pool query a random base point plus N(0, query_noise_sigma) noise.
They are drawn on the device with a `torch.Generator` in a few large
calls (not numpy's stream on the host, so the values differ from
`make_dataset`'s; the distribution is the same). A configuration with
`"normalize": true` then divides each point and each pool query by its L2
norm, in f32 on the device: the angular deployment's "normalize, then
L2" (`diskrag_tpu_torch/tools/angular_bench.py::make_angular_dataset`),
under which L2 order is cosine order.
"""

from __future__ import annotations

import numpy as np
import torch

_ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz      ", np.uint8)


def torch_seed(seed: int) -> int:
    """A seed `torch.Generator.manual_seed` takes, from any whole number."""
    return int(seed) % (2**63)


def make_points(cfg: dict, seed: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(points f32 [n, dim], pool queries f32 [query_pool, dim]) on `device`."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed))
    n, d = int(cfg["n"]), int(cfg["dim"])
    centers = torch.randn(int(cfg["n_clusters"]), d, generator=g, device=device)
    centers *= float(cfg["center_sigma"])
    assign = torch.randint(0, centers.shape[0], (n,), generator=g, device=device)
    pts = torch.randn(n, d, generator=g, device=device)
    pts *= float(cfg["noise_sigma"])
    pts += centers[assign]
    del centers, assign
    qi = torch.randint(0, n, (int(cfg["query_pool"]),), generator=g, device=device)
    queries = torch.randn(qi.shape[0], d, generator=g, device=device)
    queries *= float(cfg["query_noise_sigma"])
    queries += pts[qi]
    if cfg.get("normalize"):
        pts /= torch.linalg.vector_norm(pts, dim=1, keepdim=True)
        queries /= torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    return pts, queries


def make_texts(cfg: dict, seed: int) -> list[str]:
    """One text a row, `text_chars_min` to `text_chars_max` characters of
    lower-case letters and spaces (a chunk's length range in the
    collection's default chunking)."""
    rng = np.random.default_rng([int(seed), 1])
    n = int(cfg["n"])
    lens = rng.integers(int(cfg["text_chars_min"]), int(cfg["text_chars_max"]) + 1, n)
    blob = _ALPHABET[rng.integers(0, len(_ALPHABET), int(lens.sum()))].tobytes().decode("ascii")
    ends = np.cumsum(lens)
    return [blob[s:e] for s, e in zip((ends - lens).tolist(), ends.tolist())]


def row_metadata(i: int) -> dict:
    """The metadata stored with row i: the document and chunk it stands for."""
    return {"doc": i // 4, "chunk": i % 4}
