"""The default vamana build of both packages on the same data: each package
builds `index_type="vamana"` with its defaults at R = 24 (the tuner's R from
100,000 points up, set here for a CPU-sized set; the residual PQ's m = 16 is
the tuner's own at this size) and serves it by its own engine in
"pq_accelerated" mode at `l_search=64`. The port-built index must reach the
JAX-built one's recall@10 less 0.01 (the parity rule of port-built graphs
and quantizers: it may do better, not worse). On the CPU."""

import numpy as np
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.build_index import build_index_from_vectors as jax_build
from diskrag_tpu.data.collection import CollectionManager as JaxManager
from diskrag_tpu.data.config import CollectionInfo as JaxInfo
from diskrag_tpu.engine import SearchEngine as JaxEngine

from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k
from diskrag_tpu_torch.build_index import build_index_from_vectors as torch_build
from diskrag_tpu_torch.engine import SearchEngine as TorchEngine

N, D, B, K = 6000, 128, 200, 10
DEFAULTS_AT_200K = {"R": 24, "L": 64, "alpha": 1.2}


def _collection(base, name, pts):
    mgr = JaxManager(base)
    (base / name).mkdir(parents=True)
    np.save(mgr.get_vectors_path(name), pts)
    mgr.save_collection_info(JaxInfo(
        name=name, config={}, dimension=pts.shape[1], num_vectors=len(pts),
        created_at="", updated_at="", source_files=[],
    ))
    return mgr.get_index_dir(name)


def test_default_vamana_build_reaches_the_jax_builds_recall(tmp_path):
    pts, q = make_dataset(N, D, B, seed=42)
    gt = ground_truth(pts, q, K, device="cpu")
    metas, recall = {}, {}
    for pkg, build, engine in (("jax", jax_build, JaxEngine), ("torch", torch_build, TorchEngine)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        metas[pkg] = build(pts, _collection(tmp_path, pkg, pts), params_override=DEFAULTS_AT_200K,
                           **kw)
        eng = engine(pkg, base_dir=str(tmp_path), **kw)
        _, ids, stats = eng.search_batch(q, k=K, l_search=64)
        assert stats["search_type"] == "pq_accelerated", pkg
        recall[pkg] = recall_at_k(np.asarray(ids), gt, K)
    for meta in metas.values():
        assert meta["index_type"] == "vamana" and meta["R"] == 24
        assert meta["pq_kind"] == "residual" and meta["n_subvectors"] == 16
    assert recall["torch"] >= recall["jax"] - 0.01, recall
