"""The comparison that decides `correct`: every answer served in the
window, held against the plain reference (`reference.py`).

Numbers, each with the limit the configuration's `correct` block gives:

- `dist_rel_err` (at most): the widest relative gap between a returned
  distance and the exact (float64) L2 distance of the returned id to its
  query, over every result of every request;
- `recall_at_10` (at least): the mean recall of every query answered
  against the reference's exact top-k;
- `bad_rows` (0): result rows with fewer than k hits, an id outside the
  collection, a repeated id, or distances out of ascending order;
- `join_mismatch` (0): results whose text is not the collection's text of
  their id, plus, over a seeded sample of requests, results whose
  metadata is not that row's;
- `wrong_path` (0): requests the engine served by another search type
  than the configuration's;
- `failed` (0): requests that raised.
"""

from __future__ import annotations

import numpy as np
import torch

from cudabench import reference


def gather(requests: list[dict], k: int) -> dict:
    """The window's answers as arrays: pool query of each answered query,
    ids [Q, k] (-1 where a row is short), distances [Q, k] (NaN there),
    texts [Q, k] (None there), and the sampled requests' full results."""
    done = [r for r in requests if r.get("ids") is not None]
    if not done:
        return {"qidx": np.zeros(0, np.int64), "ids": np.zeros((0, k), np.int64),
                "dists": np.zeros((0, k)), "texts": np.zeros((0, k), object), "kept": []}
    return {
        "qidx": np.concatenate([r["qidx"] for r in done]),
        "ids": np.concatenate([r["ids"] for r in done]),
        "dists": np.concatenate([r["dists"] for r in done]),
        "texts": np.concatenate([r["texts"] for r in done]),
        "kept": [(r["qidx"], r["kept"]) for r in done if r.get("kept") is not None],
    }


def extract(results: list, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids, distances, texts) [B, k] of `search_many`'s result lists; a row
    shorter than k is padded with -1 / NaN / None, a longer one cut."""
    b = len(results)
    if all(len(row) == k for row in results):
        flat = [r for row in results for r in row]
        ids = np.fromiter((r["metadata"]["vector_index"] for r in flat), np.int64, b * k)
        dists = np.fromiter((r["distance"] for r in flat), np.float64, b * k)
        texts = np.empty(b * k, object)
        texts[:] = [r["text"] for r in flat]
        return ids.reshape(b, k), dists.reshape(b, k), texts.reshape(b, k)
    ids = np.full((b, k), -1, np.int64)
    dists = np.full((b, k), np.nan)
    texts = np.full((b, k), None, object)
    for i, row in enumerate(results):
        for j, r in enumerate(row[:k]):
            ids[i, j] = r["metadata"].get("vector_index", -1)
            dists[i, j] = r["distance"]
            texts[i, j] = r["text"]
    return ids, dists, texts


def bad_rows(ids: np.ndarray, dists: np.ndarray, n: int) -> int:
    if ids.size == 0:
        return 0
    out_of_range = ((ids < 0) | (ids >= n)).any(axis=1)
    srt = np.sort(ids, axis=1)
    repeated = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    with np.errstate(invalid="ignore"):
        disorder = ~(np.diff(dists, axis=1) >= 0).all(axis=1) | np.isnan(dists).any(axis=1)
    return int(np.sum(out_of_range | repeated | disorder))


def join_mismatch(ans: dict, texts: np.ndarray, n: int) -> int:
    ids, got = ans["ids"], ans["texts"]
    valid = (ids >= 0) & (ids < n)
    wrong = int(np.sum(got[valid] != texts[ids[valid]]))
    for _, rows in ans["kept"]:
        for row in rows:
            for r in row:
                idx = r["metadata"].get("vector_index", -1)
                if not 0 <= idx < n or (r["text"], r["metadata"]) != reference.row_join(texts, idx):
                    wrong += 1
    return int(wrong)


def evaluate(requests: list[dict], points: torch.Tensor, queries: torch.Tensor,
             texts: np.ndarray, cfg: dict, expect_path: str | None) -> tuple[dict, float | None]:
    """({name: {"value", "limit", "holds"}}, mean recall or None)."""
    k, n = int(cfg["k"]), points.shape[0]
    lim = cfg["correct"]
    ans = gather(requests, k)
    rec_mean = None
    dist_err = 0.0
    if ans["qidx"].size:
        uq, inv = np.unique(ans["qidx"], return_inverse=True)
        truth, _ = reference.exact_topk(points, queries[torch.as_tensor(uq, device=points.device)], k)
        rec_mean = float(np.mean(reference.recall(ans["ids"], truth[inv])))
        ref_d = reference.pair_distances(points, queries, ans["qidx"], ans["ids"])
        ok = ~np.isnan(ref_d) & ~np.isnan(ans["dists"])
        if ok.any():
            gap = np.abs(ans["dists"][ok] - ref_d[ok]) / np.maximum(ref_d[ok], 1e-12)
            dist_err = float(gap.max())
    failed = sum(r["error"] is not None for r in requests)
    wrong_path = 0 if expect_path is None else sum(
        r["error"] is None and r["search_type"] != expect_path for r in requests)
    rows = [
        ("dist_rel_err", dist_err, float(lim["dist_rel_err"]), "<="),
        ("recall_at_10", -1.0 if rec_mean is None else rec_mean, float(lim["recall_at_10"]), ">="),
        ("bad_rows", bad_rows(ans["ids"], ans["dists"], n), 0, "<="),
        ("join_mismatch", join_mismatch(ans, texts, n), 0, "<="),
        ("wrong_path", wrong_path, 0, "<="),
        ("failed", failed, 0, "<="),
    ]
    checks = {}
    for name, value, limit, op in rows:
        holds = value <= limit if op == "<=" else value >= limit
        checks[name] = {"value": value, "limit": limit, "op": op, "holds": bool(holds)}
    return checks, rec_mean
