"""The plain reference: exact nearest neighbours and exact distances in
plain PyTorch, and each row's text and metadata as the benchmark made
them. It imports nothing of the program and reads nothing the program
made; it works everything out again from the benchmark's own inputs.

`ControlEngine` is the same reference put in the program's place and
computed one precision lower (TF32 products for float32), the control
that the comparison deciding `correct` has to fail.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from cudabench.datagen import row_metadata


@contextlib.contextmanager
def full_float32():
    """Matrix products in full float32 (the card's TF32 mode off), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _query_block(n: int) -> int:
    """Queries a block: [block, n] f32 scores take about 2 GB."""
    return max(1, min(4096, (1 << 29) // max(n, 1)))


def exact_topk(points: torch.Tensor, queries: torch.Tensor, k: int,
               margin: int = 22) -> tuple[np.ndarray, np.ndarray]:
    """Exact L2 top-k of each query: (ids int64 [Q, k], distances f64
    [Q, k]), ascending, ties by id. A float32 screen (TF32 off) keeps the
    k + margin nearest candidates, whose distances are then taken in
    float64 from the differences; float32's error on these distances is
    far smaller than the gap between the k-th and the (k + margin)-th."""
    n = points.shape[0]
    c = min(n, k + margin)
    out_i, out_d = [], []
    with full_float32():
        norms = torch.sum(points * points, dim=1)
        for s in range(0, queries.shape[0], _query_block(n)):
            q = queries[s : s + _query_block(n)]
            scores = norms[None, :] - 2.0 * (q @ points.T)
            cand = torch.topk(scores, c, dim=1, largest=False).indices
            del scores
            diff = points[cand].double() - q.double()[:, None, :]
            d2 = torch.sum(diff * diff, dim=2)
            # sort by (distance, id): ids first, then a stable sort by distance
            cand, order = torch.sort(cand, dim=1)
            d2 = torch.gather(d2, 1, order)
            d2, order = torch.sort(d2, dim=1, stable=True)
            cand = torch.gather(cand, 1, order)
            out_i.append(cand[:, :k].cpu().numpy())
            out_d.append(torch.sqrt(d2[:, :k]).cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_d)


def pair_distances(points: torch.Tensor, queries: torch.Tensor, qidx: np.ndarray,
                   ids: np.ndarray, block: int = 1 << 16) -> np.ndarray:
    """Exact L2 distance (float64) between query `qidx[i]` and point
    `ids[i, j]` for every pair; NaN where the id is outside the points."""
    n = points.shape[0]
    out = np.full(ids.shape, np.nan)
    flat_q = np.repeat(qidx, ids.shape[1])
    flat_i = ids.reshape(-1)
    res = out.reshape(-1)
    ok = np.flatnonzero((flat_i >= 0) & (flat_i < n))
    for s in range(0, ok.size, block):
        sel = ok[s : s + block]
        qi = torch.as_tensor(flat_q[sel], device=points.device)
        pi = torch.as_tensor(flat_i[sel], device=points.device)
        diff = points[pi].double() - queries[qi].double()
        res[sel] = torch.sqrt(torch.sum(diff * diff, dim=1)).cpu().numpy()
    return out


def recall(got: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Recall of each row of `got` [Q, k] against `truth` [Q, k]."""
    k = truth.shape[1]
    hit = (got[:, :, None] == truth[:, None, :]) & (got[:, :, None] >= 0)
    return hit.any(axis=2).sum(axis=1) / k


def row_join(texts, i: int) -> tuple[str, dict]:
    """The text and metadata the collection holds for row i, as served:
    the stored metadata with the row's `vector_index`."""
    return texts[i], {**row_metadata(i), "vector_index": i}


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest), as
    the card's TF32 mode rounds a product's inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class ControlEngine:
    """The reference in the engine's place at TF32: brute force over the
    points with products of TF32 inputs (each input rounded to TF32 as the
    card's TF32 mode rounds it, float32 sums; done explicitly, since the
    card takes a one-query product outside its tensor cores in full
    float32), the distances from those products, the rows' texts joined.
    Answers `search_many` as the engine does."""

    def __init__(self, points: torch.Tensor, texts):
        self.points = round_to_tf32(points)
        self.texts = texts
        self.norms = torch.sum(points * points, dim=1)

    def search_many(self, queries, k, embedding_fn, l_search=None):
        t0 = time.perf_counter()
        qv = np.stack([np.asarray(embedding_fn(q), np.float32) for q in queries])
        t1 = time.perf_counter()
        q = torch.as_tensor(qv, device=self.points.device)
        qn = torch.sum(q * q, dim=1)
        with full_float32():
            prod = round_to_tf32(q) @ self.points.T
        d2 = self.norms[None, :] + qn[:, None] - 2.0 * prod
        top, ids = torch.topk(d2, k, dim=1, largest=False)
        dists = torch.sqrt(torch.clamp_min(top, 0.0)).double().cpu().numpy()
        ids = ids.cpu().numpy()
        t2 = time.perf_counter()
        results = []
        for id_row, d_row in zip(ids.tolist(), dists.tolist()):
            row = []
            for i, d in zip(id_row, d_row):
                text, meta = row_join(self.texts, i)
                row.append({"text": text, "distance": d, "metadata": meta})
            results.append(row)
        return {"results": results,
                "timing": {"embedding_time": t1 - t0, "search_time": t2 - t1,
                           "total_time": time.perf_counter() - t0},
                "stats": {"search_type": "control_tf32", "search_time": t2 - t1,
                          "fetch_time": 0.0}}
