"""Index build orchestration — the flat, IVF and Vamana parts of
`diskrag_tpu/build_index.py`.

Keeps the JAX package's adaptive parameter schedules (R/L by scale and
quality tier, the search-L formula) and its PQ validation gates; the
graph build (`graph/knn_build.py`) and PQ training (`pq/`) run on the
chosen device. `build_index_from_vectors` builds and persists

  - a flat index for `index_type="flat"`, and for `"auto"` below 100k
    points;
  - an IVF-Flat index (`index/ivf.py`) for `index_type="ivf"`;
  - a Vamana graph with adaptive PQ for `"vamana"`, and for `"auto"` from
    100k points up, by the kNN-based build (`build_method="knn"`) or the
    wave-insertion build (`"wave"`, `graph/build.py`); `pq_kind` int8 /
    int4 trains the int quantizer (`pq/intq.py`) instead, and
    `write_compat` adds the packed record file the host tier serves from;
  - a sharded index for `"sharded"` (`parallel/sharded.py`): `n_shards`
    Vamana sub-indexes under `index/sharded/`, the adaptive PQ over all
    points beside them, and with `write_compat` a vector-only record file
    (R = 0) for the sharded host tier.
"""

from __future__ import annotations

import json
import logging
import math
import time

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.index.persist import IndexStore, save_flat_index, save_index
from diskrag_tpu_torch.pq import ProductQuantizer, calculate_adaptive_pq_params

logger = logging.getLogger(__name__)

AUTO_FLAT_MAX_POINTS = 100_000


def calculate_adaptive_build_params(n_points: int, target_quality: str = "balanced") -> dict:
    """R/L/alpha schedule by dataset scale and quality tier."""
    if n_points <= 10_000:
        base_r, base_l = 16, 32
    elif n_points <= 50_000:
        base_r, base_l = 20, 48  # avoid the 25k recall cliff
    elif n_points <= 200_000:
        base_r, base_l = 24, 64
    else:
        base_r, base_l = 28, 80

    if target_quality == "fast":
        r, l, alpha, target_recall = int(base_r * 0.8), int(base_l * 0.8), 1.0, 0.7
    elif target_quality == "high":
        r, l, alpha, target_recall = int(base_r * 1.2), int(base_l * 1.4), 1.2, 0.95
    else:  # balanced
        r, l, alpha, target_recall = base_r, base_l, 1.2, 0.85
    return {"R": r, "L": l, "alpha": alpha, "target_recall": target_recall}


def calculate_adaptive_search_L(n_points: int, target_recall: float = 0.85) -> int:
    """Recommended query-time L."""
    if n_points <= 10_000:
        base_l = 10 * (8 + math.log10(max(n_points, 10)))
    elif n_points <= 100_000:
        base_l = 10 * (15 + 2 * math.log10(n_points))
    else:
        base_l = 10 * (20 + 3 * math.log10(n_points))
    if target_recall >= 0.9:
        base_l *= 2.0
    elif target_recall >= 0.85:
        base_l *= 1.5
    return max(20, min(int(base_l), n_points // 3))


def _vector_stats(vectors: np.ndarray) -> dict:
    norms = np.linalg.norm(vectors, axis=1)
    return {
        "mean_norm": float(norms.mean()),
        "std_norm": float(norms.std()),
        "min_norm": float(norms.min()),
        "max_norm": float(norms.max()),
        "mean": float(vectors.mean()),
        "std": float(vectors.std()),
    }


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _validate_pq(pq, vectors: np.ndarray, codes: np.ndarray,
                 coarse_ids: np.ndarray | None = None) -> dict:
    """PQ acceptance checks: encode determinism, reconstruction error,
    exact-vs-ADC correlation, for a plain ProductQuantizer, a ResidualPQ
    and an IntQuantizer (whose "codes" are its int8 rows)."""
    n = len(vectors)
    sample = np.random.default_rng(0).choice(n, size=min(256, n), replace=False)
    residual = coarse_ids is not None
    if residual:
        codes2, cids2 = pq.encode(vectors[sample])
        consistent = bool(
            (codes2.cpu().numpy() == codes[sample]).all()
            and (cids2.cpu().numpy() == coarse_ids[sample]).all()
        )
    else:
        consistent = bool((_host(pq.encode(vectors[sample])) == codes[sample]).all())

    recon_err = pq.reconstruction_error(vectors[sample])
    base = float(np.mean(np.sum(np.square(vectors[sample]), axis=1)))
    rel_err = recon_err / max(base, 1e-12)

    # exact vs ADC correlation on sampled query/point pairs (the engine
    # checks it again at startup)
    qs = vectors[sample[: min(16, len(sample))]]
    tables = pq.compute_distance_tables(qs)
    if residual:
        adc = pq.asymmetric_distance_sq(tables, codes[sample], coarse_ids[sample])
    else:
        adc = pq.asymmetric_distance_sq(tables, codes[sample])
    adc = adc.cpu().numpy()
    exact = ((qs[:, None, :] - vectors[sample][None, :, :]) ** 2).sum(-1)
    corrs = [float(np.corrcoef(adc[i], exact[i])[0, 1]) for i in range(len(qs))]
    corr = float(np.nanmean(corrs))
    return {
        "encode_consistent": consistent,
        "reconstruction_error": float(recon_err),
        "relative_reconstruction_error": float(rel_err),
        "exact_adc_correlation": corr,
        "selectivity": pq.estimate_selectivity(n),
        "passed": bool(consistent and corr >= 0.5),
    }


def _resolve_pq_kind(pq_kind: str, metric: str) -> str:
    """"auto" trains a ResidualPQ on L2 indexes (plain-PQ ADC ordering
    collapses on clustered data, `pq/residual.py`) and a plain PQ
    otherwise (ADC traversal is L2-only anyway). "int8" / "int4" train the
    int quantizer (`pq/intq.py`), L2 only."""
    if pq_kind == "auto":
        return "residual" if metric == "l2" else "plain"
    if pq_kind in ("int8", "int4") and metric != "l2":
        raise ValueError(f"pq_kind={pq_kind} is L2-only (normalize + l2 for cosine)")
    if pq_kind not in ("plain", "residual", "int8", "int4"):
        raise ValueError(f"unknown pq_kind: {pq_kind}")
    return pq_kind


def _train_pq(vectors: np.ndarray, n_subvectors: int, kind: str, *, seed: int = 0,
              opq_iters: int = 0, device: str | torch.device = "cuda"):
    """Fit the requested quantizer kind; returns (pq, codes, coarse_ids)
    as numpy arrays, coarse_ids None for plain PQ. For int8 / int4 the
    "codes" are the IntQuantizer's int8 rows (`n_subvectors` is ignored:
    the dimension and the bit depth set the row width)."""
    if kind in ("int8", "int4"):
        from diskrag_tpu_torch.pq import IntQuantizer, default_iq_cells

        bits = int(kind[3:])
        iq = IntQuantizer(bits=bits, n_cells=default_iq_cells(len(vectors), bits),
                          device=device).fit(vectors, seed=seed)
        return iq, iq.encode(vectors), None
    if kind == "residual":
        from diskrag_tpu_torch.pq import ResidualPQ, default_n_coarse

        if opq_iters:
            logger.warning(
                "opq_iters is ignored for residual PQ (rotation would "
                "have to be applied before the coarse quantizer)"
            )
        rpq = ResidualPQ(
            n_subvectors=n_subvectors, n_coarse=default_n_coarse(len(vectors)), device=device,
        ).fit(vectors, seed=seed)
        codes, cids = rpq.encode(vectors)
        return rpq, codes.cpu().numpy(), cids.cpu().numpy()
    pq = ProductQuantizer(n_subvectors=n_subvectors, device=device).fit(
        vectors, seed=seed, opq_iters=opq_iters
    )
    return pq, pq.encode(vectors).cpu().numpy(), None


def attach_pq(
    vectors: np.ndarray,
    *,
    n_subvectors: int | None = None,
    target_accuracy: str = "balanced",
    opq_iters: int = 0,
    seed: int = 0,
    pq_kind: str = "plain",
    device: str | torch.device = "cuda",
):
    """Train a PQ model on an index's vectors and encode every point.
    Returns (pq, codes, validation); (None, None, None) when the adaptive
    tuner recommends brute force (an explicit `n_subvectors` overrides the
    tuner). pq_kind "residual" returns a ResidualPQ whose coarse_ids ride
    in validation["coarse_ids"]."""
    vectors = np.asarray(vectors, np.float32)
    if n_subvectors is None:
        rec = calculate_adaptive_pq_params(len(vectors), vectors.shape[1], target_accuracy)
        if rec.recommendation == "brute_force":
            return None, None, None
        n_subvectors = rec.n_subvectors
    pq, codes, cids = _train_pq(
        vectors, n_subvectors, pq_kind, seed=seed, opq_iters=opq_iters, device=device,
    )
    validation = _validate_pq(pq, vectors, codes, coarse_ids=cids)
    if cids is not None:
        validation["coarse_ids"] = cids
    return pq, codes, validation


def _resolve_use_pq(n: int, dim: int, pq_target: str, force_pq: bool | None):
    """The train-PQ decision: the adaptive tuner by default, with the
    config's `index.force_pq` on top. Returns (use_pq, rec)."""
    rec = calculate_adaptive_pq_params(n, dim, pq_target)
    use = rec.recommendation != "brute_force"
    if force_pq is False:
        return False, rec
    if force_pq is True and not use:
        # the usual blocker is the tuner's 1000-point gate; ask again at
        # the smallest size it accepts so a legal m is still chosen
        rec2 = calculate_adaptive_pq_params(max(n, 1000), dim, pq_target)
        if rec2.recommendation != "brute_force":
            logger.info(
                "force_pq: training PQ m=%d despite the adaptive "
                "brute-force recommendation", rec2.n_subvectors,
            )
            return True, rec2
        logger.warning(
            "force_pq requested but no subvector count divides "
            "dimension %d — building without PQ", dim,
        )
        return False, rec
    return use, rec


def _pq_target(target_quality: str) -> str:
    return {"fast": "space_saving", "high": "high_accuracy"}.get(target_quality, "balanced")


def build_index_from_vectors(
    vectors: np.ndarray,
    index_dir,
    *,
    target_quality: str = "balanced",
    metric: str = "l2",
    index_type: str = "vamana",
    force_rebuild: bool = False,
    write_compat: bool = False,
    seed: int = 0,
    params_override: dict | None = None,
    build_method: str = "knn",
    opq_iters: int = 0,
    force_pq: bool | None = None,
    pq_kind: str = "auto",
    checkpoint_dir=None,
    flat_precision: str = "int8",
    flat_rerank_width: int | None = None,
    ivf_n_cells: int | None = None,
    ivf_cap_factor: float | None = None,
    n_shards: int | None = None,
    device: str = "cuda",
) -> dict:
    """Build + persist an index; returns its meta.

    index_type: "vamana" (default: graph index + adaptive PQ), "flat"
    (exhaustive scan, vectors only), "ivf" (IVF-Flat: `ivf_n_cells` and
    `ivf_cap_factor`, None for `build_ivf`'s defaults), "sharded"
    (`n_shards` partitioned Vamana sub-indexes; serving needs as many mesh
    devices as a multiple of it) or "auto" (flat under 100k points, else
    vamana). An existing index is kept unless `force_rebuild` (a
    request for a different type is logged at WARNING). `device` is
    resolved first, so a run meant for the card fails here when none is
    visible.

    `force_pq`: None = the adaptive tuner decides; True = train PQ even
    below the tuner's 1000-point gate (if any legal m divides the
    dimension); False = never train PQ. `checkpoint_dir`: mid-build
    checkpoint and resume of the graph build's IVF kNN pass (builds above
    2M points, `graph/checkpoint.py`); the flat kNN backend ignores it."""
    resolve_device(device)
    if flat_precision not in ("int8", "int8_packed", "bf16"):
        raise ValueError(f"unknown flat_precision: {flat_precision!r}")
    store = IndexStore(index_dir)
    if not force_rebuild and store.exists():
        prev = json.loads(store.meta_path.read_text())
        prev_type = prev.get("index_type", "vamana")
        if index_type not in ("auto", prev_type):
            logger.warning(
                "existing index at %s is type=%s but type=%s was requested "
                "— keeping the existing one (use force_rebuild to convert)",
                store.dir, prev_type, index_type,
            )
        else:
            logger.info("index already exists at %s (use force_rebuild)", store.dir)
        return prev
    if not force_rebuild and store.meta_path.exists():
        prev = json.loads(store.meta_path.read_text())
        if (prev.get("index_type") == "sharded"
                and (store.dir / "sharded" / "sharded_meta.json").exists()):
            if n_shards and int(prev.get("n_shards", 0)) != int(n_shards):
                logger.warning(
                    "existing sharded index has %s shards, requested %s — keeping the "
                    "existing one (use force_rebuild)", prev.get("n_shards"), n_shards,
                )
            if write_compat and not prev.get("write_compat"):
                logger.warning(
                    "existing sharded index lacks the compat record file needed for "
                    "host_tier serving (use force_rebuild with write_compat)"
                )
            logger.info("sharded index already exists at %s (use force_rebuild)", store.dir)
            return prev

    vectors = np.asarray(vectors)
    if vectors.dtype != np.float32:
        vectors = vectors.astype(np.float32)
    if vectors.ndim == 1:
        vectors = vectors.reshape(1, -1)
    n, dim = vectors.shape
    if n < 16:
        raise ValueError(f"need at least 16 vectors to build an index, got {n}")
    if index_type == "auto":
        index_type = "flat" if n < AUTO_FLAT_MAX_POINTS else "vamana"
    if index_type == "flat":
        meta = save_flat_index(
            index_dir, vectors, metric=metric,
            meta_extra={
                "target_quality": target_quality,
                "flat_precision": flat_precision,
                "flat_rerank_width": flat_rerank_width,
                "vector_stats": _vector_stats(vectors),
            },
        )
        logger.info("flat index persisted -> %s", store.dir)
        return meta
    if index_type == "ivf":
        from diskrag_tpu_torch.index.ivf import build_ivf
        from diskrag_tpu_torch.index.persist import save_ivf_index

        t0 = time.perf_counter()
        ivf_kwargs = {} if ivf_cap_factor is None else {"cap_factor": ivf_cap_factor}
        stages: dict = {}
        ivf = build_ivf(vectors, ivf_n_cells, metric=metric, seed=seed, device=device,
                        stage_seconds=stages, **ivf_kwargs)
        meta = save_ivf_index(
            index_dir, ivf, host_vectors=vectors,
            meta_extra={
                "target_quality": target_quality,
                "build_seconds": time.perf_counter() - t0,
                "build_stage_seconds": stages,  # fit, assign, place, tiles
                "vector_stats": _vector_stats(vectors),
            },
        )
        logger.info("ivf index persisted -> %s", store.dir)
        return meta
    if index_type == "sharded":
        return _build_sharded(
            vectors, store, n_shards=int(n_shards or 1), target_quality=target_quality,
            metric=metric, write_compat=write_compat, seed=seed,
            params_override=params_override, build_method=build_method, opq_iters=opq_iters,
            force_pq=force_pq, pq_kind=pq_kind, device=device,
        )
    if index_type != "vamana":
        raise ValueError(f"unknown index_type: {index_type}")
    if build_method not in ("knn", "wave"):
        raise ValueError(f"unknown build_method: {build_method}")
    params = calculate_adaptive_build_params(n, target_quality)
    if params_override:
        params.update(params_override)
    r, l, alpha = params["R"], params["L"], params["alpha"]
    logger.info("build params: N=%d R=%d L=%d alpha=%.2f", n, r, l, alpha)

    use_pq, pq_rec = _resolve_use_pq(n, dim, _pq_target(target_quality), force_pq)
    pq = codes = coarse_ids = pq_validation = None
    if use_pq:
        t0 = time.perf_counter()
        kind = _resolve_pq_kind(pq_kind, metric)
        pq, codes, coarse_ids = _train_pq(
            vectors, pq_rec.n_subvectors, kind, seed=seed, opq_iters=opq_iters, device=device,
        )
        pq_validation = _validate_pq(pq, vectors, codes, coarse_ids=coarse_ids)
        logger.info(
            "PQ kind=%s m=%d trained in %.1fs (corr=%.3f)",
            kind, pq_rec.n_subvectors, time.perf_counter() - t0,
            pq_validation["exact_adc_correlation"],
        )
        if not pq_validation["passed"]:
            logger.warning("PQ validation failed — keeping PQ but flagging meta")

    t0 = time.perf_counter()
    if build_method == "knn":
        from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

        index = build_vamana_knn(
            vectors, degree_bound=r, alpha=alpha, metric=metric, seed=seed,
            progress=True, checkpoint_dir=checkpoint_dir, device=device,
        )
    else:
        from diskrag_tpu_torch.graph.build import build_vamana

        index = build_vamana(
            vectors, degree_bound=r, build_width=l, alpha=alpha, metric=metric, seed=seed,
            progress=True, device=device,
        )
    build_seconds = time.perf_counter() - t0

    meta = save_index(
        index_dir, index, pq=pq, pq_codes=codes, pq_coarse_ids=coarse_ids,
        host_vectors=vectors, write_compat=write_compat,
        meta_extra={
            "L": l,
            "alpha": alpha,
            "target_quality": target_quality,
            "target_recall": params["target_recall"],
            "recommended_search_L": calculate_adaptive_search_L(n, params["target_recall"]),
            "vector_stats": _vector_stats(vectors),
            "pq_validation": pq_validation,
            "build_seconds": build_seconds,
            "build_method": build_method,
        },
    )
    logger.info("index built in %.1fs -> %s", build_seconds, store.dir)
    return meta


def _build_sharded(vectors: np.ndarray, store: IndexStore, *, n_shards: int, target_quality: str,
                   metric: str, write_compat: bool, seed: int, params_override: dict | None,
                   build_method: str, opq_iters: int, force_pq: bool | None, pq_kind: str,
                   device: str) -> dict:
    """The `index_type="sharded"` branch: per-shard graphs
    (`parallel.sharded.build_sharded`) saved under `index/sharded/`, the
    adaptive PQ over all points (the sharded host tier's pq / iq mode),
    the vector-only record file with `write_compat`, and the JAX package's
    meta keys. `build_shards` in the meta holds each shard's seconds,
    stage seconds and kernel launches."""
    from diskrag_tpu_torch.index.persist import (
        _atomic_write_bytes,
        save_pq_artifacts,
        write_compat_records,
    )
    from diskrag_tpu_torch.parallel.sharded import build_sharded, save_sharded_index

    n, dim = vectors.shape
    params = calculate_adaptive_build_params(n, target_quality)
    if params_override:
        params.update(params_override)
    stages: dict = {}
    shard_stats: list = []
    t0 = time.perf_counter()
    sharded = build_sharded(
        vectors, n_shards, degree_bound=params["R"], build_width=params["L"],
        alpha=params["alpha"], metric=metric, seed=seed, build_method=build_method,
        device=device, shard_stats=shard_stats,
    )
    stages["shards"] = time.perf_counter() - t0
    t = time.perf_counter()
    save_sharded_index(sharded, store.dir / "sharded")  # makes store.dir
    stages["save"] = time.perf_counter() - t
    del sharded
    use_pq, pq_rec = _resolve_use_pq(n, dim, _pq_target(target_quality), force_pq)
    pq_meta = {}
    if use_pq:
        t = time.perf_counter()
        pq, pq_codes, pq_cids = _train_pq(
            vectors, pq_rec.n_subvectors, _resolve_pq_kind(pq_kind, metric), seed=seed,
            opq_iters=opq_iters, device=device,
        )
        pq_meta = save_pq_artifacts(store, pq, pq_codes, coarse_ids=pq_cids)
        stages["pq"] = time.perf_counter() - t
    if write_compat:
        # the f32 master for the sharded host tier's exact rerank; R = 0
        # records (each shard's adjacency lives in the sharded artifacts)
        t = time.perf_counter()
        write_compat_records(store.compat_path, vectors, np.empty((n, 0), np.int32))
        stages["compat"] = time.perf_counter() - t
    meta = {
        "index_type": "sharded",
        "n_shards": n_shards,
        "write_compat": bool(write_compat),
        "compat_R": 0,
        "use_pq": bool(pq_meta),
        **pq_meta,
        "dimension": dim,
        "num_points": n,
        "R": params["R"],
        "L": params["L"],
        "alpha": params["alpha"],
        "distance_metric": metric,
        "target_quality": target_quality,
        "recommended_search_L": calculate_adaptive_search_L(n, params["target_recall"]),
        "vector_stats": _vector_stats(vectors),
        "build_seconds": time.perf_counter() - t0,
        "build_method": build_method,
        "build_stage_seconds": stages,
        "build_shards": shard_stats,
    }
    _atomic_write_bytes(store.meta_path, json.dumps(meta, indent=2).encode())
    logger.info("sharded index (%d shards) persisted -> %s", n_shards, store.dir)
    return meta
