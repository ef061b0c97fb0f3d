"""User-facing dataset benchmark (counterpart of
`diskrag_tpu/tools/dataset_benchmark.py`): load vectors (parquet/npy or a
seeded synthetic set), build the graph, compute the exact ground truth,
and sweep recall / latency / QPS for exact traversal and for PQ-guided
traversal + rerank, on the chosen device.

    python -m diskrag_tpu_torch.tools.dataset_benchmark --n 100000 --dim 128
    python -m diskrag_tpu_torch.tools.dataset_benchmark --vectors data.npy --queries q.npy

Not ported yet (each raises `NotImplementedError` naming ROADMAP.md):
`--build-method wave` (the insertion build of `graph/build`) and
`--host-tier` (the host-offload tier).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def load_vectors(path: str) -> np.ndarray:
    """npy or parquet (any numeric columns / a single list column)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".parquet"):
        import pandas as pd

        df = pd.read_parquet(path)
        first = df.iloc[:, 0]
        if first.dtype == object:  # list column
            return np.stack(first.to_numpy()).astype(np.float32)
        return df.to_numpy().astype(np.float32)
    raise ValueError(f"unsupported vector file: {path}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="diskrag_tpu_torch dataset benchmark")
    ap.add_argument("--vectors", help="npy/parquet vectors (default: synthetic)")
    ap.add_argument("--queries", help="npy/parquet queries")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--R", type=int, default=32)
    ap.add_argument("--L-build", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=1.2)
    ap.add_argument("--widths", default="32,48,64,96,128")
    ap.add_argument("--expand", default="1,4")
    ap.add_argument("--pq-m", type=int, default=0, help="0 = skip PQ sweep")
    ap.add_argument("--host-tier", action="store_true",
                    help="sweep the host-offload tier (not ported yet)")
    ap.add_argument("--build-method", choices=["knn", "wave"], default="knn")
    ap.add_argument(
        "--metric", choices=["l2", "cosine", "dot"], default="l2",
        help="distance metric (the PQ sweep is L2-only and is skipped for other metrics)",
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--json", action="store_true", help="JSON output only")
    args = ap.parse_args(argv)

    from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, sweep_exact, sweep_pq
    from diskrag_tpu_torch.device import resolve_device
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

    dev = resolve_device(args.device)
    if args.build_method == "wave":
        raise NotImplementedError(
            "--build-method wave (the insertion build of graph/build) is not ported yet "
            "(ROADMAP.md, 'Modules still to port'); use --build-method knn")
    if args.host_tier:
        raise NotImplementedError(
            "--host-tier (the host-offload tier) is not ported yet "
            "(ROADMAP.md, 'Modules still to port')")

    if args.vectors:
        pts = load_vectors(args.vectors)
        if args.queries:
            queries = load_vectors(args.queries)[: args.n_queries]
        else:
            rng = np.random.default_rng(0)
            qi = rng.integers(0, len(pts), size=args.n_queries)
            queries = pts[qi] + rng.normal(
                size=(args.n_queries, pts.shape[1])
            ).astype(np.float32) * 0.05
    else:
        pts, queries = make_dataset(args.n, args.dim, args.n_queries)

    widths = tuple(int(x) for x in args.widths.split(","))
    expands = tuple(int(x) for x in args.expand.split(","))

    t0 = time.perf_counter()
    index = build_vamana_knn(
        pts, degree_bound=args.R, alpha=args.alpha, metric=args.metric, device=dev,
    )
    build_s = time.perf_counter() - t0
    gt = ground_truth(pts, queries, args.k, metric=args.metric, device=args.device)

    points = sweep_exact(index, queries, gt, k=args.k, widths=widths, expand_widths=expands)
    if args.pq_m and args.metric != "l2":
        print(f"(--pq-m skipped: the ADC tables are L2-only, metric={args.metric})")
        args.pq_m = 0
    if args.pq_m:
        from diskrag_tpu_torch.pq import ProductQuantizer

        pq = ProductQuantizer(n_subvectors=args.pq_m, device=dev).fit(pts)
        codes = pq.encode(pts)
        points += sweep_pq(index, pq, codes, queries, gt, k=args.k, widths=widths,
                           expand_widths=expands)

    # process memory report: psutil where installed, else the stdlib
    # (ru_maxrss is KiB on linux)
    try:
        import psutil

        rss_mb = psutil.Process().memory_info().rss / 1e6
    except ImportError:
        import resource

        rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3
    result = {
        "n": len(pts), "dim": pts.shape[1], "n_queries": len(queries),
        "R": args.R, "L_build": args.L_build, "alpha": args.alpha,
        "metric": args.metric,
        "build_method": args.build_method,
        "device": str(dev),
        "build_seconds": round(build_s, 1),
        "host_rss_mb": round(rss_mb, 1),
        "sweep": [
            {
                "mode": p.mode, "L": p.search_width, "E": p.expand_width,
                "recall": round(p.recall, 4), "qps": round(p.qps, 1),
                "latency_ms": round(p.mean_latency_ms, 3),
            }
            for p in points
        ],
    }
    if args.json:
        print(json.dumps(result))
    else:
        print(f"N={result['n']} dim={result['dim']} build={build_s:.1f}s")
        for p in result["sweep"]:
            print(
                f"  {p['mode']:<10} L={p['L']:<4} E={p['E']:<2} "
                f"recall@{args.k}={p['recall']:.4f} qps={p['qps']:>9.1f}"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
