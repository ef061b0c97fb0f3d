"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `diskrag_tpu_torch/csrc/` (into
`build/diskrag_tpu_torch/`), holds each against its plain PyTorch version
on the card, then serves the flat index end to end at the benchmark's
size (1,000,000 x 128 vectors, 1000 queries, k = 10) through
`build_index_from_vectors` and `SearchEngine.search_batch`, and checks
recall@10 against an exact ground truth. Every phase prints one JSON
line; the line before the last is the card's name and power limit as
nvidia-smi gives them, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failure (no card, a build error, a mismatch, low recall, a kernel the
main path did not launch) exits non-zero before that line. Nothing here
imports jax or the JAX package.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (dense): int8 tensor cores, f32 outside them,
# HBM3 bandwidth. Bounds are stated against these, beside the power limit.
PEAK_INT8_OPS = 1979e12
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

MAIN_N, MAIN_D, MAIN_B, MAIN_K = 1_000_000, 128, 1000, 10
CMP_N = 200_000


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, after
    one warm-up call (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def b1_bound_ms(b: int, n: int, d: int, nb: int) -> tuple[float, str]:
    """Least time for B1's int8 work over the n valid rows (the table's
    pad rows cannot change the result): the products (2 ops per
    multiply-add) at the int8 tensor-core peak, or each input byte read
    once (codes, the two norm-block rows, query codes and scales) and
    each output byte written once ([B, NB] vals + ids) at HBM bandwidth
    — the larger."""
    t_ops = 2.0 * b * n * d / PEAK_INT8_OPS
    nbytes = n * d + n * 8 + b * d + b * 4 + b * nb * 8
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def b4_bound_ms(b: int, nb: int, kk: int) -> tuple[float, str]:
    """Least time for B4's work: read the [B, NB] block once, write the
    [B, kk] lanes once; one f32 compare per input element."""
    t_bytes = (b * nb * 4 + b * kk * 4) / PEAK_BYTES
    t_ops = b * nb / PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def phase_device() -> dict:
    import torch

    from diskrag_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        stem: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for stem, log in _build.build_logs.items()
    }
    emit({
        "phase": "device", "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_seconds": round(build_s, 3),
        "kernels_built": sorted(paths), "ptxas": ptxas,
    })
    return {"smi": smi}


def _scan_inputs(pts_dev, q_dev, metric: str):
    """(query codes, q_scales, table codes, norm block, n, scan source,
    float queries) as the main path builds them (`FlatIndex` +
    `flat_search_fused`)."""
    import torch

    from diskrag_tpu_torch.ops.flat_scan import build_rowscan_table, quantize_int8

    if metric == "cosine":
        src = pts_dev * torch.rsqrt(torch.sum(pts_dev * pts_dev, -1) + 1e-12)[:, None]
        qf = q_dev / (torch.sqrt(torch.sum(q_dev * q_dev, -1, keepdim=True)) + 1e-12)
    else:
        src, qf = pts_dev, q_dev
    codes, block, _, n = build_rowscan_table(src, metric=metric)
    qc, qs = quantize_int8(qf)
    return qc, qs, codes, block, n, src, qf


def compare_b1(queries, db, db_norms, *, n_buckets, use_norms, q_scales=None,
               db_scales=None, n_valid=None):
    """B1's public wrapper on card tensors against the plain version on
    the operands the wrapper builds from the same arguments (NB shrink,
    bf16 query doubling, norm-block stacking). int8: vals and ids must be
    bit-identical. bf16 (products exact in f32, summed in another order
    than the plain version's f32 GEMM): vals within 1e-5 of the block's
    largest |score|, ids equal except where two segments tie within that
    tolerance. Returns (kernel vals, the row of the kernels phase)."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    kw = dict(n_buckets=n_buckets, use_norms=use_norms, q_scales=q_scales,
              db_scales=db_scales, n_valid=n_valid)
    v_k, i_k = fs.scan_bucketed_topk(queries, db, db_norms, **kw)
    ops = fs._scan_operands(queries, db, db_norms, **kw)
    v_r, i_r = fs.scan_bucketed_topk_ref(*ops)
    torch.cuda.synchronize()
    fin = torch.isfinite(v_r)
    err = float((v_k[fin] - v_r[fin]).abs().max()) if bool(fin.any()) else 0.0
    bad = i_k != i_r
    what = (f"B1 {queries.dtype} n={ops[6]} d={queries.shape[1]} nb={ops[3]} "
            f"norms={use_norms} table={n_valid is not None}")
    row = {"kernel": "B1", "precision": str(queries.dtype).split(".")[-1],
           "n": ops[6], "d": queries.shape[1], "nb": ops[3], "use_norms": use_norms,
           "table": n_valid is not None, "max_abs_err": err}
    if queries.dtype == torch.int8:
        require(bool(torch.equal(v_k, v_r)) and not bool(bad.any()),
                f"{what} not bit-identical: max_abs_err={err} id_mismatches={int(bad.sum())}")
        row["match"] = "bit-identical"
    else:
        tol = 1e-5 * float(v_r[fin].abs().max())
        require(err <= tol and bool(torch.equal(fin, torch.isfinite(v_k))),
                f"{what} vals off by {err} > {tol}")
        near = (v_k - v_r).abs() <= tol
        require(bool((~bad | near).all()), f"{what}: id differs away from a near-tie")
        row.update(match=f"vals within {tol:.3g}; ids except near-ties",
                   id_mismatches=int(bad.sum()))
    return v_k, row


def phase_kernels() -> dict:
    """Each kernel's public wrapper against its plain version on the card,
    at the shapes of the comparison set (200k x 128, B = 1000, NB = 512
    and 8192, both int8 table forms and bf16, all three metrics) and at a
    tiny one (300 x 36: NB shrinks to 256, rows are zero-padded to 16
    bytes)."""
    import torch

    from diskrag_tpu_torch.benchmark import make_dataset
    from diskrag_tpu_torch.ops import flat_scan as fs

    dev = torch.device("cuda", 0)
    rows = []
    b4_cases = []
    for n_pts, d in ((CMP_N, MAIN_D), (300, 36)):
        pts, q = make_dataset(n_pts, d, MAIN_B, seed=7)
        pts_d = torch.as_tensor(pts, device=dev)
        q_d = torch.as_tensor(q, device=dev)
        for metric in ("l2", "cosine", "dot"):
            l2 = metric == "l2"
            qc, qs, codes, block, n, src, qf = _scan_inputs(pts_d, q_d, metric)
            for nb in (512, 8192):
                vals, row = compare_b1(qc, codes, block, n_buckets=nb, use_norms=l2,
                                       q_scales=qs, n_valid=n)
                rows.append({"metric": metric, **row})
                if l2 and n_pts == CMP_N:
                    b4_cases.append((vals, 40 if nb == 512 else 400))
            if l2:  # the unpadded int8 form: the wrapper stacks and doubles the scales
                _, db_scales = fs.quantize_int8(src)
                _, row = compare_b1(qc, codes[:n], torch.sum(src * src, -1), n_buckets=512,
                                    use_norms=True, q_scales=qs, db_scales=db_scales)
                rows.append({"metric": metric, **row})
            for nb in (512, 8192):
                _, row = compare_b1(qf.to(torch.bfloat16), src.to(torch.bfloat16),
                                    torch.sum(src * src, -1), n_buckets=nb, use_norms=l2)
                rows.append({"metric": metric, **row})
        del pts_d, q_d
    # B4 on real scan blocks plus a block built for ties and exhaustion
    g = torch.Generator(device="cpu").manual_seed(3)
    ties = torch.randint(0, 4, (64, 512), generator=g).to(torch.float32)
    ties[::3, 100:] = float("-inf")
    ties[5] = float("-inf")
    b4_cases.append((ties.to(dev), 40))
    for vals, kk in b4_cases:
        lk = fs.topk_lanes(vals, kk)
        lr = fs.topk_lanes_ref(vals, kk)
        torch.cuda.synchronize()
        require(bool(torch.equal(lk, lr)), f"B4 differs at NB={vals.shape[1]} kk={kk}")
        rows.append({"kernel": "B4", "b": vals.shape[0], "nb": vals.shape[1], "kk": kk,
                     "match": "bit-identical",
                     "sentinels": int((lr == vals.shape[1]).sum())})
    for r in rows:
        emit({"phase": "kernels", **r})
    del b4_cases
    torch.cuda.empty_cache()
    return {}


def profile_batch(engine, q, steps: int = 3) -> dict:
    """Device time by kernel name per `search_batch` (torch.profiler,
    CUPTI; one warm-up step first, since the profiler can miss kernels at
    its start) and the device's idle share of the profiled host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    wall_ms = 0.0
    events: list = []  # the active cycle's events, taken before the profiler clears them
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for i in range(steps + 1):
            t = time.perf_counter()
            engine.search_batch(q, k=MAIN_K)
            if i:
                wall_ms += (time.perf_counter() - t) * 1e3
            prof.step()
    by_name: dict[str, float] = {}
    for e in events:  # device-side work only; the step ranges are annotations
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "phase": "profile", "batches": steps, "wall_ms_per_batch": wall_ms / steps,
        "device_busy_ms_per_batch": busy,
        "device_idle_share": (1.0 - busy * steps / wall_ms) if busy else "not measured",
        "device_ms_by_kernel_per_batch": [[k[:90], v] for k, v in top],
    }


def phase_main(smi: str) -> dict:
    """The main path at the bench size, plus each kernel's time at the
    shapes the main path hands it."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.data.collection import CollectionManager
    from diskrag_tpu_torch.data.config import CollectionInfo
    from diskrag_tpu_torch.engine import SearchEngine
    from diskrag_tpu_torch.ops import flat_scan as fs

    t0 = time.perf_counter()
    pts, q = make_dataset(MAIN_N, MAIN_D, MAIN_B, seed=42)
    base = ROOT / "build" / "chip_smoke" / "collections"
    shutil.rmtree(base, ignore_errors=True)
    name = "bench_1m"
    mgr = CollectionManager(base)
    (base / name).mkdir(parents=True)
    np.save(mgr.get_vectors_path(name), pts)
    mgr.save_collection_info(CollectionInfo(
        name=name, config={}, dimension=MAIN_D, num_vectors=MAIN_N,
        created_at="", updated_at="", source_files=[],
    ))
    meta = build_index_from_vectors(pts, mgr.get_index_dir(name), index_type="flat",
                                    device="cuda")
    require(meta["index_type"] == "flat", "build did not make a flat index")
    engine = SearchEngine(name, base_dir=str(base), device="cuda")
    require(bool(engine.diagnostics and engine.diagnostics["passed"]),
            f"startup diagnostic failed: {engine.diagnostics}")
    setup_s = time.perf_counter() - t0

    reps = 5
    fs.reset_launch_counts()
    batch_s = []
    for _ in range(reps):
        t = time.perf_counter()
        dists, ids, stats = engine.search_batch(q, k=MAIN_K)
        batch_s.append(time.perf_counter() - t)
    launches = {"B1": fs.scan_bucketed_topk.launches, "B4": fs.topk_lanes.launches}
    require(launches["B1"] > 0 and launches["B4"] > 0,
            f"main path did not launch every kernel: {launches}")
    require(ids.shape == (MAIN_B, MAIN_K) and dists.shape == (MAIN_B, MAIN_K),
            "result shape")
    require(bool(np.isfinite(dists).all()), "non-finite distances")

    t = time.perf_counter()
    gt = ground_truth(pts, q, MAIN_K, device="cuda")
    gt_s = time.perf_counter() - t
    recall = recall_at_k(ids, gt, MAIN_K)
    # the nearest distance must agree with the exact one (sqrt at the edge)
    pts_d = torch.as_tensor(pts, device="cuda")
    q_d = torch.as_tensor(q, device="cuda")
    exact0 = torch.sqrt(torch.sum((pts_d[torch.as_tensor(gt[:, 0], device="cuda").long()] - q_d) ** 2, -1))
    d0_err = float(np.max(np.abs(dists[:, 0] - exact0.cpu().numpy())))
    require(recall >= 0.97, f"recall@10 {recall} < 0.97")
    med = float(np.median(batch_s))
    emit({
        "phase": "main", "n": MAIN_N, "d": MAIN_D, "queries": MAIN_B, "k": MAIN_K,
        "recall_at_10": recall, "qps": MAIN_B / med,
        "ms_per_batch_median": med * 1e3, "ms_per_batch": [s * 1e3 for s in batch_s],
        "top1_dist_max_abs_err": d0_err, "launches": launches,
        "launches_per_search_batch": {k: v / reps for k, v in launches.items()},
        "setup_seconds": setup_s, "ground_truth_seconds": gt_s,
        "search_type": stats["search_type"], "card": smi,
    })

    emit(profile_batch(engine, q))

    # kernel times at the main path's shapes (these launches are not
    # counted above: the counts were read before)
    flat = engine.flat
    qc, qs = fs.quantize_int8(q_d)
    nb, n_valid = 512, flat._fused_n_valid
    args = (qc, flat._fused_db, flat._fused_db_norms)
    kw = dict(n_buckets=nb, use_norms=True, q_scales=qs, n_valid=n_valid)
    vals, row = compare_b1(*args, **kw)
    err = row["max_abs_err"]
    ops = fs._scan_operands(*args, db_scales=None, **kw)
    b1_ms = cuda_ms(lambda: fs.scan_bucketed_topk(*args, **kw), 10)
    b1_plain = cuda_ms(lambda: fs.scan_bucketed_topk_ref(*ops), 3)
    kk = 40
    lk, lr = fs.topk_lanes(vals, kk), fs.topk_lanes_ref(vals, kk)
    require(bool(torch.equal(lk, lr)), "B4 differs at the main-path shape")
    b4_ms = cuda_ms(lambda: fs.topk_lanes(vals, kk), 50)
    b4_plain = cuda_ms(lambda: fs.topk_lanes_ref(vals, kk), 20)
    b4_lib = cuda_ms(lambda: torch.topk(vals, kk, dim=1), 50)
    b1_bound, b1_by = b1_bound_ms(MAIN_B, n_valid, MAIN_D, nb)
    b4_bound, b4_by = b4_bound_ms(MAIN_B, nb, kk)
    kernels = [
        {"name": "B1 flat_scan (per-row int8 scan + bucket fold)", "route": "cuda",
         "source": "diskrag_tpu_torch/csrc/flat_scan.cu",
         "replaces": "diskrag_tpu/ops/flat_scan_pallas.py:42",
         "launches": launches["B1"], "max_abs_err": err, "match": "bit-identical",
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound, "bound_by": b1_by,
         "library_ms": None},
        {"name": "B4 topk_lanes (candidate cut)", "route": "cuda",
         "source": "diskrag_tpu_torch/csrc/topk_lanes.cu",
         "replaces": "diskrag_tpu/ops/flat_scan_pallas.py:1244",
         "launches": launches["B4"], "max_abs_err": 0.0, "match": "bit-identical",
         "ms": b4_ms, "plain_ms": b4_plain, "bound_ms": b4_bound, "bound_by": b4_by,
         "library_ms": b4_lib},
    ]
    del engine, flat, pts_d, q_d
    shutil.rmtree(base, ignore_errors=True)
    return {"kernels": kernels}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "diskrag_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout (diskrag_tpu_torch/ not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    dev = phase_device()
    phase_kernels()
    out = phase_main(dev["smi"])
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(json.dumps({"kernels": out["kernels"]}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
