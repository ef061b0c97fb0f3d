"""Microbenchmark of the fused flat-scan path, stage by stage (counterpart
of `benchmarks/fused_scan_micro.py`).

Takes the flat path apart so kernel work can be attributed: the bucketed
scans alone (per-row int8 and bf16 on B1, the packed fold on B2, the
hierarchical fold on B3 and its pipelined variant B6), the full fused
paths (scan + candidate cut + exact f32 rerank), the cut and the rerank
alone, the matmul-only probe M1 (the packed scans' product with the fold
taken out: a packed scan's time less M1's at the same shapes is what the
fold costs), the tail decomposition, the pre-padded table contract, and a
sweep. One JSON line per stage; stage names are the original's where the
stage is the same. Every line carries the kernel launches the stage
caused (`launches`, by kernel id, over `calls` calls), so the output
itself shows which kernel a stage went through. Timing through
`diskrag_tpu_torch.benchmark._measure` (host clock around whole passes,
each window closed by a device synchronize).

    python -m diskrag_tpu_torch.tools.fused_scan_micro --n 200000 --queries 1000
    python -m diskrag_tpu_torch.tools.fused_scan_micro --n 2000 --queries 64 --device cpu

What differs from the original, and why:

  - No `db_tile` / `query_block` axes. Those are VMEM block sizes of the
    TPU kernels; the CUDA kernels size their own tiles, and nothing a
    caller passes changes them. The hierarchical stages and `--sweep`
    walk what does change results or kernels here: `n_buckets`, the fold
    (per-row int8, bf16, packed / hierarchical) and `pipelined`. The
    hierarchical stages keep the original's names at its default tile
    request (`_t2048`), which in the port only sets the pad rows scanned.
    M1 keeps its `tile` argument: there it defines the function.
  - No approximate top-k. Where the original times `approx_max_k` the
    port times what its path runs in that place, and the stage is named
    for it: B4 (`rerank_cut_only_topk_lanes`) and the exact stable
    `ops.topk.topk_smallest` (`packed_no_rerank_topk_smallest`).
  - A stage that fails raises. The original catches VMEM overflows and
    carries on; nothing here may fail while the run exits 0.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device

HIER_VARIANTS = ((False, 512), (False, 1024), (True, 512), (True, 1024))
MM_TILES = (2048, 4096)


def _print_line(line: dict) -> None:
    print(json.dumps(line), flush=True)


def run(
    *, n: int = 200_000, dim: int = 128, queries: int = 1000, k: int = 10,
    repeats: int = 3, device: str = "cuda", sweep: bool = False,
    only: tuple[str, ...] | None = None, min_seconds: float = 1.5,
    data: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
    emit=_print_line,
) -> list[dict]:
    """Run the stages and return their lines (each also handed to `emit`).

    `only`: run just the stages whose name starts with one of these
    prefixes. `data`: (points, queries, ground-truth ids) to use instead
    of the seeded `make_dataset(n, dim, queries)` and its exact ground
    truth."""
    from diskrag_tpu_torch.benchmark import _measure, ground_truth, make_dataset, recall_at_k
    from diskrag_tpu_torch.kernels.launches import launch_counts, reset_launch_counts
    from diskrag_tpu_torch.ops import flat_scan as fs
    from diskrag_tpu_torch.ops.distance import Metric, rerank_exact_topk
    from diskrag_tpu_torch.ops.mm_probe import mm_probe
    from diskrag_tpu_torch.ops.topk import topk_smallest

    dev = resolve_device(device)
    if data is None:
        pts, qs_np = make_dataset(n, dim, queries)
        gt = ground_truth(pts, qs_np, k, device=device)
    else:
        pts, qs_np, gt = data
    nq = len(qs_np)
    v = torch.as_tensor(np.asarray(pts, np.float32), device=dev)
    q = torch.as_tensor(np.asarray(qs_np, np.float32), device=dev)
    norms = torch.sum(v * v, dim=-1)
    lines: list[dict] = []

    def wanted(name: str) -> bool:
        return only is None or name.startswith(tuple(only))

    def stage(name: str, fn, ids_of=None, extra: dict | None = None):
        """Time `fn` and report it; returns its last result (None when the
        stage is filtered out)."""
        if not wanted(name):
            return None
        fn()  # builds the operands the stage needs (cached below), outside the counted calls
        reset_launch_counts()
        dt, out, calls = _measure(fn, repeats, dev, min_seconds)
        counts = {kid: c for kid, c in launch_counts().items() if c}
        line = {"stage": name, "qps": round(nq / dt, 1), "batch_ms": round(dt * 1e3, 4)}
        if ids_of is not None:
            line["recall"] = round(recall_at_k(ids_of(out).cpu().numpy(), gt, k), 4)
        line.update(extra or {})
        line.update(launches=counts, calls=calls, device=str(dev))
        lines.append(line)
        emit(line)
        return out

    def ids(out):
        return out[1]

    # Operands are built on first use (a stage's first call, which is
    # neither timed nor counted), so `only` pays for nothing it does not run.
    @functools.cache
    def per_row():  # per-row int8 codes + scales of the table and the queries
        codes, scales = fs.quantize_int8(v)
        return fs.align_code_rows(codes), scales, *fs.quantize_int8(q)

    @functools.cache
    def bf16():
        return fs.align_code_rows(v.to(torch.bfloat16)), q.to(torch.bfloat16)

    @functools.cache
    def packed():  # one scale for the table, one for the batch
        gcodes, gscale = fs.quantize_int8_global(v)
        return fs.align_code_rows(gcodes), gscale, *fs.quantize_int8_global(q)

    @functools.cache
    def table():  # the pre-padded table contract: what FlatIndex serves from
        tcodes, tnf, tscale, tn = fs.build_packed_scan_table(v)
        return fs.align_code_rows(tcodes), tnf, tscale, tn

    def scan_packed(**kw):
        gcodes, gscale, gq, gqs = packed()
        return fs.scan_bucketed_topk_packed(gq, gqs, gcodes, norms, gscale, **kw)

    def scan_hier(**kw):
        gcodes, gscale, gq, gqs = packed()
        return fs.scan_bucketed_topk_hier(gq, gqs, gcodes, norms, gscale, **kw)

    def fused(fold: str, **kw):
        if fold == "int8":
            codes, scales, _, _ = per_row()
            return fs.flat_search_fused(q, codes, norms, v, k=k, db_scales=scales, **kw)
        if fold == "bf16":
            return fs.flat_search_fused(q, bf16()[0], norms, v, k=k, **kw)
        gcodes, gscale, _, _ = packed()
        return fs.flat_search_fused(q, gcodes, norms, v, k=k, db_scale_global=gscale, **kw)

    packed_out = functools.cache(scan_packed)  # (scores, ids) of the packed scan
    hier_out = functools.cache(scan_hier)      # of the hierarchical scan, NB = 512

    # the per-row int8 and bf16 scans alone (B1), then the full fused path
    def scan_int8():
        codes, scales, qcodes, qscales = per_row()
        return fs.scan_bucketed_topk(qcodes, codes, norms, q_scales=qscales, db_scales=scales)

    stage("scan_only_int8", scan_int8)
    stage("scan_only_bf16", lambda: fs.scan_bucketed_topk(bf16()[1], bf16()[0], norms))
    stage("fused_full_int8", lambda: fused("int8"), ids)

    # the packed-int32 fold
    stage("scan_only_packed", scan_packed)
    stage("fused_full_packed", lambda: fused("packed"), ids)

    # the hierarchical packed fold (NB free of the 256-segment budget) and
    # its pipelined variant
    for pipe, hnb in HIER_VARIANTS:
        stage(f"scan_only_hier_{'pipe' if pipe else 'plain'}_nb{hnb}_t2048",
              lambda: scan_hier(n_buckets=hnb, pipelined=pipe))

    # rerank breakdown on the packed scan's output: the cut alone (B4),
    # then cut + candidate gather + exact distances + final top-k
    def cut_width():
        return min(40, packed_out()[0].shape[1])

    stage("rerank_cut_only_topk_lanes", lambda: fs.topk_lanes(packed_out()[0], cut_width()))
    stage("rerank_full",
          lambda: fs._rerank(q, v, *packed_out(), k, cut_width(), Metric.L2), ids)

    # the matmul-only floor: the packed scans' whole product, no fold
    for tile in MM_TILES:
        nb_out = min(512, tile)
        out = stage(f"scan_mm_only_t{tile}",
                    lambda: mm_probe(packed()[2], packed()[0], tile=tile, nb_out=nb_out),
                    extra={"tile": tile, "nb_out": nb_out})
        if out is not None:
            # the checked output: every product of every tile was added in
            gcodes, _, gq, _ = packed()
            want = (gq.to(torch.int64) * gcodes.sum(0, dtype=torch.int64)[None, :]).sum(1)
            got = out[1][:nq].to(torch.int64)
            if not bool(((got - want) % (1 << 32) == 0).all()):
                raise RuntimeError(f"scan_mm_only_t{tile}: the all-column row sum is wrong")

    # tail decomposition on a hierarchical-width score block (NB = 512):
    # the cut, then candidate gather + exact distances + final top-k
    for tkk in (20, 40):
        stage(f"tail_cut_topk_lanes_nb512_kk{tkk}",
              lambda: fs.topk_lanes(hier_out()[0], min(tkk, hier_out()[0].shape[1])))

        @functools.cache
        def candidates(width=tkk):
            hs, hi = hier_out()
            take = fs.topk_lanes(hs, min(width, hs.shape[1])).long()
            dead = take >= hs.shape[1]
            return torch.where(dead, -1, torch.gather(hi, 1, torch.where(dead, 0, take)))

        stage(f"tail_gather_exact_kk{tkk}",
              lambda: rerank_exact_topk(q, v, candidates(), k, Metric.L2), ids)

    def scan_table(scan):
        tcodes, tnf, tscale, tn = table()
        gq, gqs = packed()[2:]
        return scan(gq, gqs, tcodes, tnf, tscale, n_valid=tn)

    stage("scan_only_packed_table", lambda: scan_table(fs.scan_bucketed_topk_packed))
    stage("scan_only_hier_table", lambda: scan_table(fs.scan_bucketed_topk_hier))
    for rw in (None, 20):
        def fused_table():
            tcodes, tnf, tscale, tn = table()
            return fs.flat_search_fused(q, tcodes, norms, v, k=k, db_scale_global=tscale,
                                        db_nf=tnf, n_valid=tn, rerank_width=rw)

        stage(f"fused_full_table_rr{rw or 'def'}", fused_table, ids)

    # no rerank: trust the packed scores outright (exact stable top-k)
    def norerank():
        scores, cids = packed_out()
        top_s, take = topk_smallest(-scores, k)
        return -top_s, torch.gather(cids, 1, take)

    stage("packed_no_rerank_topk_smallest", norerank, ids)

    if sweep:
        for fold, nb in ((f, b) for f in ("int8", "bf16", "packed") for b in (512, 1024, 2048)):
            stage("sweep", lambda: fused(fold, n_buckets=nb), ids,
                  {"fold": fold, "n_buckets": nb})
        for pipe, nb in ((p, b) for p in (False, True) for b in (256, 512, 1024, 2048)):
            stage("sweep_scan_hier", lambda: scan_hier(n_buckets=nb, pipelined=pipe),
                  extra={"n_buckets": nb, "pipelined": pipe})
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="fused flat-scan microbenchmark (PyTorch/CUDA port)")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--min-seconds", type=float, default=1.5,
                    help="grow each stage's repeat count until a timed window lasts this long")
    ap.add_argument("--only", nargs="+", default=None, metavar="PREFIX",
                    help="run only the stages whose name starts with one of these")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep (fold, n_buckets) and (pipelined, n_buckets)")
    args = ap.parse_args(argv)
    run(n=args.n, dim=args.dim, queries=args.queries, k=args.k, repeats=args.repeats,
        device=args.device, sweep=args.sweep, only=args.only, min_seconds=args.min_seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
