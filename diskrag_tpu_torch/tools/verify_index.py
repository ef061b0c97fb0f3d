"""Structural index verification (counterpart of
`diskrag_tpu/tools/verify_index.py`): artifact presence, size-formula
checks on the packed record file where a directory has one, adjacency
invariants, sampled read-backs, and a search smoke test on the chosen
device.

    python -m diskrag_tpu_torch.tools.verify_index <index_dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

from diskrag_tpu_torch.device import resolve_device


def verify_index(index_dir: str | pathlib.Path, *, device: str = "cuda") -> dict:
    from diskrag_tpu_torch.index.persist import IndexStore, load_index, read_compat_records

    dev = resolve_device(device)
    store = IndexStore(index_dir)
    report: dict = {"index_dir": str(store.dir), "checks": {}, "ok": True}

    def check(name: str, passed: bool, detail: str = ""):
        report["checks"][name] = {"passed": bool(passed), "detail": detail}
        if not passed:
            report["ok"] = False

    check("meta_exists", store.meta_path.exists())
    if not store.meta_path.exists():
        return report
    meta = json.loads(store.meta_path.read_text())
    index_type = meta.get("index_type", "vamana")
    report["index_type"] = index_type
    if index_type != "vamana":
        # flat/ivf/sharded metas carry no R and keep their arrays in their
        # own artifact sets: run the structural checks that apply (they
        # need no engine, so directories of types the port does not serve
        # yet are verified too)
        check("num_points", meta.get("num_points", 0) > 0)
        check("dimension", meta.get("dimension", 0) > 0)
        if index_type == "flat":
            ok = store.vectors_path.exists()
            check("vectors_exists", ok)
            if ok:
                v = np.load(store.vectors_path, mmap_mode="r")
                check(
                    "vectors_shape",
                    v.shape == (meta["num_points"], meta["dimension"]),
                    f"{v.shape}",
                )
        elif index_type == "ivf":
            for name in ("ivf_centroids", "ivf_tile_ids", "vectors"):
                check(f"{name}_exists", (store.dir / f"{name}.npy").exists())
        elif index_type == "sharded":
            _verify_sharded(store, meta, check)
        return report
    n, dim, r = meta["num_points"], meta["dimension"], meta["R"]

    check("vectors_exists", store.vectors_path.exists())
    check("adjacency_exists", store.adjacency_path.exists())
    if not (store.vectors_path.exists() and store.adjacency_path.exists()):
        return report

    vectors = np.load(store.vectors_path, mmap_mode="r")
    adjacency = np.load(store.adjacency_path, mmap_mode="r")
    check("vectors_shape", vectors.shape == (n, dim), f"{vectors.shape} vs ({n}, {dim})")
    check("adjacency_shape", adjacency.shape == (n, r), f"{adjacency.shape} vs ({n}, {r})")
    adj = np.asarray(adjacency)
    check("adjacency_ids_in_range", bool(((adj >= -1) & (adj < n)).all()))
    check("no_self_loops", bool(~(adj == np.arange(n)[:, None]).any()))
    degs = (adj >= 0).sum(1)
    check("min_degree>=1", bool(degs.min() >= 1), f"min degree {degs.min()}")
    check("medoid_in_range", 0 <= meta["medoid_idx"] < n, str(meta["medoid_idx"]))

    if meta.get("use_pq"):
        check("pq_model_exists", store.pq_model_path.exists())
        check("pq_codes_exists", store.pq_codes_path.exists())
        if store.pq_codes_path.exists():
            codes = np.load(store.pq_codes_path, mmap_mode="r")
            check("pq_codes_shape", codes.shape == (n, meta["n_subvectors"]), f"{codes.shape}")

    if store.compat_path.exists():
        record_size = 4 * (dim + r)
        expect = n * record_size
        actual = store.compat_path.stat().st_size
        check("record_file_size", actual == expect, f"{actual} vs {expect} (= N * 4*(dim+R))")
        if actual == expect:
            v2, a2 = read_compat_records(store.compat_path, n, dim, r)
            sample = np.random.default_rng(0).choice(n, size=min(64, n), replace=False)
            check("record_vectors_match",
                  bool(np.allclose(v2[sample], np.asarray(vectors[sample]))))
            check("record_adjacency_match", bool((a2[sample] == adj[sample]).all()))

    # search smoke test: a database point should find itself. A verifier
    # reports a failure as a failed check, whatever raised it
    try:
        import torch

        from diskrag_tpu_torch.graph.search import beam_search

        index, _, _, _ = load_index(store.dir, device=dev)
        probe = np.random.default_rng(1).choice(n, size=min(8, n), replace=False)
        # the serving configuration: the index's own metric and entry
        # points (kNN-built graphs rely on seeds for navigation)
        res = beam_search(
            index.vectors, index.adjacency, index.medoid,
            index.vectors[torch.as_tensor(probe, device=dev)], search_width=32, k=1,
            metric=index.metric, entry_points=index.entry_points,
        )
        found = res.ids.cpu().numpy()[:, 0]
        check("self_search", bool((found == probe).mean() >= 0.9),
              f"{(found == probe).mean():.2f} of probes found themselves")
    except Exception as e:  # noqa: BLE001
        check("self_search", False, f"{type(e).__name__}: {e}")
    return report


def _verify_sharded(store, meta: dict, check) -> None:
    """The files `parallel.sharded.save_sharded_index` writes under
    `sharded/`: its meta (format, shard count), each array and its shape,
    local ids in range, the global ids covering every point once, and the
    vector-only record file (R = 0) of a `write_compat` build."""
    from diskrag_tpu_torch.parallel.sharded import SHARDED_FORMAT_VERSION

    sdir = store.dir / "sharded"
    check("sharded_dir_exists", sdir.is_dir())
    if not sdir.is_dir():
        return
    names = ["vectors", "adjacency", "medoids", "global_ids"]
    smeta_path = sdir / "sharded_meta.json"
    check("sharded_meta_exists", smeta_path.exists())
    smeta = json.loads(smeta_path.read_text()) if smeta_path.exists() else {}
    if smeta:
        check("sharded_format", smeta.get("format") == SHARDED_FORMAT_VERSION,
              str(smeta.get("format")))
        check("n_shards", smeta.get("n_shards") == meta.get("n_shards"),
              f"{smeta.get('n_shards')} vs {meta.get('n_shards')}")
        if smeta.get("has_entry_points"):
            names.append("entry_points")
    for name in names:
        check(f"{name}_exists", (sdir / f"{name}.npy").exists())
    if not smeta or not all((sdir / f"{name}.npy").exists() for name in names):
        return
    arr = {name: np.load(sdir / f"{name}.npy", mmap_mode="r") for name in names}
    s, ns, dim = smeta["n_shards"], smeta["points_per_shard"], smeta["dim"]
    r = smeta["degree_bound"]
    check("vectors_shape", arr["vectors"].shape == (s, ns, dim), f"{arr['vectors'].shape}")
    check("adjacency_shape", arr["adjacency"].shape == (s, ns, r), f"{arr['adjacency'].shape}")
    check("medoids_shape", arr["medoids"].shape == (s,), f"{arr['medoids'].shape}")
    check("global_ids_shape", arr["global_ids"].shape == (s, ns), f"{arr['global_ids'].shape}")
    adj = np.asarray(arr["adjacency"])
    check("adjacency_ids_in_range", bool(((adj >= -1) & (adj < ns)).all()))
    med = np.asarray(arr["medoids"])
    check("medoids_in_range", bool(((med >= 0) & (med < ns)).all()))
    if "entry_points" in arr:
        ep = np.asarray(arr["entry_points"])
        check("entry_points_in_range", ep.shape[0] == s and bool(((ep >= 0) & (ep < ns)).all()))
    g = np.asarray(arr["global_ids"])
    valid = np.sort(g[g >= 0])
    n = int(meta.get("num_points", 0))
    check("global_ids_cover_points", valid.shape[0] == n and bool((valid == np.arange(n)).all()),
          f"{valid.shape[0]} valid global ids for {n} points")
    if meta.get("write_compat"):
        expect = n * 4 * dim
        actual = store.compat_path.stat().st_size if store.compat_path.exists() else -1
        check("record_file_size", actual == expect, f"{actual} vs {expect} (= N * 4*dim, R = 0)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="verify an index directory")
    ap.add_argument("index_dir")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    report = verify_index(args.index_dir, device=args.device)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
