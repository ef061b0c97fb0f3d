"""Batched k-means: m independent problems trained at once (counterpart
of `diskrag_tpu/pq/kmeans.py`).

Data is [m, N, d], centroids [m, K, d]; every Lloyd step is a batched
product (assignment) and a one-hot product (centroid update) in full
f32, walked over N in tiles so the [m, tile, K] distance block stays
small. Seeding is k-means++ (K sequential rounds of D²-proportional
Gumbel sampling) or a one-shot joint D² draw. Random numbers come from a
`torch.Generator` on the data's device; `init_centers` replaces the
seeding, which lets a test hold the deterministic Lloyd iterations to
the JAX package's on carried-over centres.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device: torch.device | str) -> torch.Generator:
    """A generator on `device` seeded with `seed`. (The CPU and the CUDA
    generators draw different streams from one seed.)"""
    return torch.Generator(device=device).manual_seed(int(seed))


def _batched_sq_dists(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[m, N, d] x [m, K, d] -> [m, N, K] squared L2."""
    dn = torch.sum(data * data, dim=-1)
    cn = torch.sum(centers * centers, dim=-1)
    cross = torch.bmm(data, centers.transpose(1, 2))
    return torch.clamp_min(dn[..., None] + cn[:, None, :] - 2.0 * cross, 0.0)


def _gumbel(shape, generator: torch.Generator, device, dtype) -> torch.Tensor:
    e = torch.empty(shape, device=device, dtype=dtype).exponential_(generator=generator)
    return -torch.log(e)


def _log_weights(min_d: torch.Tensor) -> torch.Tensor:
    """log(min_d) with -inf for zero-distance points."""
    pos = min_d > 0
    return torch.where(pos, torch.log(torch.where(pos, min_d, torch.ones_like(min_d))),
                       -torch.inf)


def _kmeanspp_init(generator: torch.Generator, data: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding, batched over the leading m axis: [m, N, d] ->
    [m, K, d]. Sequential over K; each round is one [m, N] distance
    update, and the next centre is drawn with probability proportional to
    the current min squared distance (Gumbel-max)."""
    m, n, d = data.shape
    dev = data.device
    rows = torch.arange(m, device=dev)
    first = torch.randint(0, n, (m,), generator=generator, device=dev)
    centers = torch.zeros((m, k, d), dtype=data.dtype, device=dev)
    centers[:, 0] = data[rows, first]
    diff = data - centers[:, 0][:, None, :]
    min_d = torch.sum(diff * diff, dim=-1)
    for i in range(1, k):
        g = _gumbel((m, n), generator, dev, data.dtype)
        logits = _log_weights(min_d) + g
        # all distances 0 (degenerate data): a uniform pick instead
        all_zero = torch.all(min_d <= 0, dim=1)
        uniform_pick = torch.randint(0, n, (m,), generator=generator, device=dev)
        pick = torch.where(all_zero, uniform_pick, torch.argmax(logits, dim=1))
        new_c = data[rows, pick]
        centers[:, i] = new_c
        diff = data - new_c[:, None, :]
        min_d = torch.minimum(min_d, torch.sum(diff * diff, dim=-1))
    return centers


def _d2_init(generator: torch.Generator, data: torch.Tensor, k: int) -> torch.Tensor:
    """One-shot D²-weighted seeding: one random centre, then the other
    k-1 drawn jointly without replacement with probability proportional
    to distance² (Gumbel top-k). One distance pass instead of k rounds —
    the right trade when k is large and Lloyd iterations follow."""
    m, n, d = data.shape
    dev = data.device
    first = torch.randint(0, n, (m,), generator=generator, device=dev)
    c0 = data[torch.arange(m, device=dev), first]
    diff = data - c0[:, None, :]
    min_d = torch.sum(diff * diff, dim=-1)
    logits = _log_weights(min_d) + _gumbel((m, n), generator, dev, data.dtype)
    # the k-1 largest, the lower index first among equals
    picks = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, : k - 1]
    rest = torch.gather(data, 1, picks[..., None].expand(-1, -1, d))
    return torch.cat([c0[:, None, :], rest], dim=1)


def kmeans_fit(
    generator: torch.Generator | None,
    data: torch.Tensor,
    k: int,
    max_iter: int = 25,
    chunk: int = 4096,
    init: str = "kmeans++",
    init_centers: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit m batched k-means problems.

    Args:
      generator: source of the seeding's random draws (unused with
        `init_centers`).
      data: [m, N, d] — m independent point sets.
      k: centroids per problem (256 for PQ).
      max_iter: Lloyd iterations (a fixed count, as in the JAX package).
      chunk: N-axis tile of the assignment sweeps.
      init: "kmeans++" (k sequential D² rounds: best quality, right for
        small k) or "d2" (one-shot joint D² sampling: right for large k).
      init_centers: [m, K, d] initial centres, replacing the seeding.

    Returns (centers [m, K, d], assignments [m, N] int32). An empty
    cluster keeps its previous centroid.
    """
    m, n, d = data.shape
    chunk = min(chunk, n)
    if init_centers is not None:
        centers = init_centers.to(data.dtype).clone()
    elif init == "d2":
        centers = _d2_init(generator, data, k)
    else:
        centers = _kmeanspp_init(generator, data, k)

    for _ in range(max_iter):
        sums = torch.zeros((m, k, d), dtype=data.dtype, device=data.device)
        counts = torch.zeros((m, k), dtype=data.dtype, device=data.device)
        for t0 in range(0, n, chunk):
            td = data[:, t0 : t0 + chunk]
            assign = torch.argmin(_batched_sq_dists(td, centers), dim=-1)
            oh = torch.nn.functional.one_hot(assign, k).to(data.dtype)
            sums += torch.bmm(oh.transpose(1, 2), td)
            counts += torch.sum(oh, dim=1)
        new_centers = sums / torch.clamp_min(counts[..., None], 1.0)
        centers = torch.where(counts[..., None] > 0, new_centers, centers)

    assign = torch.cat(
        [
            torch.argmin(_batched_sq_dists(data[:, t0 : t0 + chunk], centers), dim=-1)
            for t0 in range(0, n, chunk)
        ],
        dim=1,
    )
    return centers, assign.to(torch.int32)
