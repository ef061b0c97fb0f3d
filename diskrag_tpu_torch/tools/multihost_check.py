"""A multi-process sharded search on one host: each process builds its own
shards and all of them search together (`parallel.multihost`).

    python -m diskrag_tpu_torch.tools.multihost_check --n 4000 --dim 32 --device cpu --out DIR

starts `--processes` workers (this module's `worker` subcommand), each on
`tcp://127.0.0.1:<free port>` over gloo (it runs on the CPU and on
processes that share one card, which NCCL refuses). Worker
r takes its block of `make_dataset(n, dim, queries, seed)`, builds
`--shards-per-process` shards with `build_local_shards`, joins the global
mesh and runs `multihost_sharded_search` and `multihost_flat_search`; it
writes its shard arrays and results to DIR/rank<r>.npz. The launcher
fails unless every worker exits 0 within `--timeout` seconds and every
worker returned byte-identical ids; `stack_shards` assembles the workers'
shards into the single-process `ShardedIndex` they form together.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(args) -> None:
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    from diskrag_tpu_torch.benchmark import make_dataset
    from diskrag_tpu_torch.parallel import multihost as mh

    cfg = mh.MultihostConfig(f"127.0.0.1:{args.port}", args.processes, args.rank,
                             shards_per_host=args.shards_per_process)
    mh.initialize(cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                  backend="gloo", timeout_s=args.timeout)
    try:
        pts, queries = make_dataset(args.n, args.dim, args.queries, seed=args.seed)
        lo, hi = cfg.my_block(args.n)
        per_host = -(-args.n // cfg.num_processes)
        per_shard = -(-per_host // cfg.shards_per_host)
        local = mh.build_local_shards(
            pts[lo:hi], lo, n_local_shards=cfg.shards_per_host, degree_bound=args.degree_bound,
            rows_per_shard=per_shard, seed=args.seed, device=args.device,
        )
        mesh = mh.global_shard_mesh(devices=[args.device] * cfg.shards_per_host)
        index = mh.assemble_global_index(local, mesh, cfg.n_global_shards)
        ids, dists = mh.multihost_sharded_search(index, queries, mesh,
                                                 search_width=args.search_width, k=args.k)
        v = local["vectors"]
        fids, fdists = mh.multihost_flat_search(
            v, np.einsum("snd,snd->sn", v, v, dtype=np.float32), local["global_ids"], queries,
            mesh, k=args.k)
        out = pathlib.Path(args.out)
        np.savez(out / f"rank{args.rank}.npz", ids=ids, dists=dists, flat_ids=fids,
                 flat_dists=fdists, queries=queries,
                 **{f"local_{k}": v for k, v in local.items() if k != "metric"})
    finally:
        mh.shutdown()


def run_local(out_dir, *, n: int, dim: int, queries: int = 64, k: int = 10,
              search_width: int = 32, processes: int = 2, shards_per_process: int = 2,
              degree_bound: int = 24, seed: int = 0, device: str = "cpu",
              timeout: float = 120.0, threads: int = 0) -> list[dict]:
    """Run the workers to their end and return each one's arrays (rank
    order). Raises if a worker fails, outlasts `timeout`, or the workers'
    ids differ in any byte."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "diskrag_tpu_torch.tools.multihost_check", "worker",
           "--port", str(port), "--processes", str(processes), "--n", str(n), "--dim", str(dim),
           "--queries", str(queries), "--k", str(k), "--search-width", str(search_width),
           "--shards-per-process", str(shards_per_process), "--degree-bound", str(degree_bound),
           "--seed", str(seed), "--device", device,
           "--timeout", str(timeout), "--threads", str(threads), "--out", str(out)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(processes)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {r} exited {p.returncode}:\n{log[-4000:]}")
    results = []
    for r in range(processes):
        with np.load(out / f"rank{r}.npz") as z:
            results.append(dict(z))
    for r in range(1, processes):
        for key in ("ids", "flat_ids"):
            if results[r][key].tobytes() != results[0][key].tobytes():
                raise RuntimeError(f"worker {r}'s {key} differ from worker 0's")
    return results


def stack_shards(results: list[dict], metric: str = "l2"):
    """The workers' shards, process-major, as one host `ShardedIndex`."""
    from diskrag_tpu_torch.parallel import ShardedIndex

    def cat(key):
        return np.concatenate([r[f"local_{key}"] for r in results])

    return ShardedIndex(vectors=cat("vectors"), adjacency=cat("adjacency"),
                        medoids=cat("medoids"), global_ids=cat("global_ids"), metric=metric,
                        entry_points=cat("entry_points"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command", nargs="?", default="run", choices=["run", "worker"])
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--shards-per-process", type=int, default=2)
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--search-width", type=int, default=32)
    ap.add_argument("--degree-bound", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.command == "worker":
        worker(args)
        return 0
    results = run_local(args.out, n=args.n, dim=args.dim, queries=args.queries, k=args.k,
                        search_width=args.search_width, processes=args.processes,
                        shards_per_process=args.shards_per_process,
                        degree_bound=args.degree_bound, seed=args.seed, device=args.device,
                        timeout=args.timeout, threads=args.threads)
    print(json.dumps({"processes": len(results), "ids": "byte-identical",
                      "shape": list(results[0]["ids"].shape)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
