"""Angular-configuration measurement (counterpart of
`benchmarks/angular_bench.py`): the compressed traversal tiers on
unit-normalized clustered vectors, in the normalize-then-L2 form (on unit
vectors L2 order is cosine order).

Protocol, as the JAX script's, step for step: `make_dataset(n, dim,
n_queries)` with every row of the points and the queries divided by its
norm (`make_angular_dataset`); an exact ground truth; `build_vamana_knn(
degree_bound=32, alpha=1.2, seed=0)`; then, on that one graph,
`sweep_exact` at L = 16 / 32 (E = 8), `IntQuantizer(bits=8)` and
`sweep_iq` at L = 16 / 32 (E = 8), `ResidualPQ(32)` and `sweep_pq` at L =
32 / 64 (E = 4) and `ResidualPQ(64, n_coarse=2048)` and `sweep_pq` at L =
64 / 96 (E = 4), each quantizer fit with seed 0 and freed before the next.
Below D = 64 a residual PQ takes m = min(m, D) subvectors (a split into
more subvectors than dimensions does not exist); at the configuration's D
= 128 nothing changes.

    python -m diskrag_tpu_torch.tools.angular_bench [--n 1200000] [--dim 128]
        [--device cuda] [--min-seconds 1.5] [--out PATH]

prints one JSON line: the JAX script's keys (`config`, `build_seconds`,
`measured`, `sweep` rows of mode / L / E / recall / qps, rounded as there)
and `stage_seconds`, the build's seconds by stage (with each stage's
`peak_device_bytes` on CUDA). `--out` also writes it, indented, to that
path; nothing is written anywhere else. `chip_smoke.py` calls `run` in
process.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

# the residual PQ rungs of the protocol: (m, coarse cells, widths), E = 4
RPQ_RUNGS = ((32, 1024, (32, 64)), (64, 2048, (64, 96)))


def make_angular_dataset(n: int, dim: int, n_queries: int, seed: int = 42):
    """`make_dataset` with each row of the points and the queries divided
    by its norm in place, in numpy and f32, as the JAX script does: the
    same arrays, bit for bit, in both packages."""
    from diskrag_tpu_torch.benchmark import make_dataset

    pts, queries = make_dataset(n, dim, n_queries, seed=seed)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return pts, queries


def _row(p) -> dict:
    return {"mode": p.mode, "L": p.search_width, "E": p.expand_width,
            "recall": round(p.recall, 4), "qps": round(p.qps, 1)}


def run(
    n: int = 1_200_000,
    dim: int = 128,
    n_queries: int = 1000,
    k: int = 10,
    *,
    device: str = "cuda",
    min_seconds: float = 1.5,
    out_path: str | pathlib.Path | None = None,
    keep: dict | None = None,
) -> dict:
    """Run the protocol; returns the result dict (see the module
    docstring). `min_seconds` is each sweep point's timed window (the JAX
    protocol's 1.5 s). `keep`, when a dict, receives what a caller that
    goes on with this run needs: `index` (the graph), `points`,
    `queries`, `gt`, `sweep_points` (the full `SweepPoint`s, with rounds
    and passes), `launches` (the kernel launches of the build and of each
    quantizer's sweep, by kernel id), `quantizer_seconds` (fit and encode
    seconds of each quantizer) and `rpq64` (the last rung's quantizer
    with its codes and coarse ids). Each quantizer is freed before the
    next one is fit."""
    from diskrag_tpu_torch.benchmark import ground_truth, sweep_exact, sweep_iq, sweep_pq
    from diskrag_tpu_torch.device import resolve_device
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
    from diskrag_tpu_torch.kernels.launches import launch_counts
    from diskrag_tpu_torch.pq import IntQuantizer, ResidualPQ

    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    launches: dict = {}

    def since(before: dict) -> dict:
        return {name: c - before[name] for name, c in launch_counts().items()}

    pts, queries = make_angular_dataset(n, dim, n_queries)
    gt = ground_truth(pts, queries, k, device=str(dev))

    stages: dict = {}
    before = launch_counts()
    t0 = time.perf_counter()
    index = build_vamana_knn(pts, degree_bound=32, alpha=1.2, seed=0, device=dev,
                             stage_seconds=stages)
    sync()
    build_s = time.perf_counter() - t0
    launches["build"] = since(before)
    sweep_kw = dict(k=k, min_seconds=min_seconds)

    before = launch_counts()
    points = sweep_exact(index, queries, gt, widths=(16, 32), expand_widths=(8,), **sweep_kw)
    launches["exact"] = since(before)

    q_seconds: dict = {}

    def fitted(tag: str, quantizer):
        t = time.perf_counter()
        quantizer.fit(pts, seed=0)
        sync()
        q_seconds[tag] = {"fit": time.perf_counter() - t}
        t = time.perf_counter()
        enc = quantizer.encode(pts)
        sync()
        q_seconds[tag]["encode"] = time.perf_counter() - t
        return quantizer, enc

    iq8, rows = fitted("iq8", IntQuantizer(bits=8, device=dev))
    before = launch_counts()
    points += sweep_iq(index, iq8, rows, queries, gt, widths=(16, 32), expand_widths=(8,),
                       **sweep_kw)
    launches["iq8"] = since(before)
    del iq8, rows

    last = None
    for m, cells, widths in RPQ_RUNGS:
        last = None  # the previous rung's quantizer and codes go before this fit
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        tag = f"rpq{m}"
        rpq, (codes, cids) = fitted(tag, ResidualPQ(n_subvectors=min(m, dim), n_coarse=cells,
                                                    device=dev))
        before = launch_counts()
        points += sweep_pq(index, rpq, codes, queries, gt, widths=widths, expand_widths=(4,),
                           coarse_ids=cids, **sweep_kw)
        launches[tag] = since(before)
        last = (rpq, codes, cids)
        del rpq, codes, cids

    result = {
        "config": f"angular-normalized-{n}",
        "build_seconds": round(build_s, 1),
        "measured": time.strftime("%Y-%m-%d"),
        "sweep": [_row(p) for p in points],
        "stage_seconds": stages,
    }
    if keep is not None:
        keep.update(index=index, points=pts, queries=queries, gt=gt, sweep_points=points,
                    launches=launches, quantizer_seconds=q_seconds, rpq64=last)
    if out_path is not None:
        pathlib.Path(out_path).write_text(json.dumps(result, indent=1))
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="diskrag_tpu_torch angular-configuration benchmark")
    ap.add_argument("--n", type=int, default=1_200_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--min-seconds", type=float, default=1.5,
                    help="timed window of each sweep point")
    ap.add_argument("--out", default=None, help="also write the result (indented JSON) here")
    args = ap.parse_args(argv)
    result = run(n=args.n, dim=args.dim, device=args.device, min_seconds=args.min_seconds,
                 out_path=args.out)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
