"""The port's sharded host tier (`diskrag_tpu_torch/parallel/host_tier.py`)
against the JAX package's, on the CPU over a 2 x 4 mesh (["cpu"] * 8) and
the JAX package's emulated 8-device mesh, on JAX-built shards with a
wrap-around pad row.

Each mode (bf16, plain PQ, residual PQ with m = 8 and m = 4, int8 rows) runs on the JAX tier's
own per-shard operands carried across (`convert.sharded_host_tier_from_jax`):
the traversal orders candidates by sums taken in another order, so the
results are held to >= 99% equal (query, rank) slots and recall within
0.002, as `test_torch_graph_search.py` holds PQ traversal. The port's own
`from_sharded_index` regathers the same per-shard codes from the global
ones (the pad rows encoded from their vectors) bit for bit, and its
`search_pipelined` returns exactly what `search` does."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.index.persist import write_compat_records
from diskrag_tpu.native import RecordReader as JaxRecordReader
from diskrag_tpu.parallel import build_sharded as jax_build_sharded, make_mesh as jax_make_mesh
from diskrag_tpu.parallel.host_tier import ShardedHostTier as JaxTier
from diskrag_tpu.pq import IntQuantizer as JaxIQ, ProductQuantizer as JaxPQ, ResidualPQ as JaxRPQ
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.convert import (
    iq_from_jax,
    pq_from_jax,
    sharded_host_tier_from_jax,
    sharded_index_from_jax,
)
from diskrag_tpu_torch.native import RecordReader
from diskrag_tpu_torch.parallel import ShardedHostTier, make_mesh

N = 1995  # 4 shards of 499: one pad row in the last


@pytest.fixture(scope="module")
def setup(clustered_data, tmp_path_factory):
    pts = clustered_data[:N]
    jidx = jax_build_sharded(pts, 4, degree_bound=24)
    path = tmp_path_factory.mktemp("sht") / "vectors.dat"
    write_compat_records(path, pts, np.empty((N, 0), np.int32))
    rng = np.random.default_rng(11)
    q = (pts[rng.integers(0, N, size=50)]
         + rng.normal(size=(50, pts.shape[1])).astype(np.float32) * 0.1).astype(np.float32)
    return {"pts": pts, "jidx": jidx, "path": path, "q": q,
            "gt": ground_truth(pts, q, 10, device="cpu")}


def _quantizer(mode, pts):
    """(JAX quantizer, from_sharded_index kwargs for the JAX package, the
    same for the port) of a mode; None for bf16."""
    if mode == "bf16":
        return {}, {}
    if mode == "iq":
        iq = JaxIQ(bits=8).fit(pts, seed=0)
        rows = np.asarray(iq.encode(pts))
        return ({"mode": "iq", "pq": iq, "codes": rows},
                {"mode": "iq", "pq": iq_from_jax(iq, device="cpu"), "codes": rows})
    if mode == "pq":
        pq = JaxPQ(n_subvectors=8).fit(pts, seed=0)
        codes = np.asarray(pq.encode(pts))
        return ({"mode": "pq", "pq": pq, "codes": codes},
                {"mode": "pq", "pq": pq_from_jax(pq.to_arrays(), device="cpu")[0],
                 "codes": codes})
    # "residual4": the adaptive tuner's space-saving choice for large sets
    # (m = 4, as the default build takes at 1M points)
    rpq = JaxRPQ(n_subvectors=4 if mode == "residual4" else 8, n_coarse=64).fit(pts, seed=0)
    codes, cids = (np.asarray(a) for a in rpq.encode(pts))
    bias = np.asarray(rpq.point_bias(codes, cids))
    aux = {"codes": codes, "pq_cells": cids, "pq_bias": bias}
    return ({"mode": "pq", "pq": rpq, **aux},
            {"mode": "pq", "pq": pq_from_jax(rpq.to_arrays(), device="cpu")[0], **aux})


@pytest.fixture(scope="module", params=["bf16", "pq", "residual", "residual4", "iq"])
def tiers(setup, request):
    mode = request.param
    jkw, tkw = _quantizer(mode, setup["pts"])
    jmesh = jax_make_mesh(n_shards=4, n_data=2)
    tmesh = make_mesh(n_shards=4, n_data=2, devices=["cpu"] * 8)
    jtier = JaxTier.from_sharded_index(
        setup["jidx"], JaxRecordReader(setup["path"], N, setup["pts"].shape[1], 0), jmesh, **jkw)
    reader = RecordReader(setup["path"], N, setup["pts"].shape[1], 0)
    carried = sharded_host_tier_from_jax(jtier, reader, tmesh)
    own = ShardedHostTier.from_sharded_index(
        sharded_index_from_jax(setup["jidx"], device="cpu"), reader, tmesh, **tkw)
    return mode, jtier, carried, own


def test_from_sharded_index_regathers_the_jax_operands(tiers):
    """Per-shard codes (pad row encoded from its own vector), residual
    cells and biases, graph and ids: bit for bit the JAX tier's."""
    mode, jtier, carried, own = tiers
    assert own.mode == jtier.mode and own.n_shards == 4
    # the JAX tier's traversal fields, and where the port's guide holds each
    guided = {"codes": "codes", "pq_cells": "cells", "pq_bias": "bias"}
    for name in ("adjacency", "medoids", "global_ids", "entry_points", *guided):
        theirs = getattr(jtier, name)
        if name not in guided:
            ours = getattr(own, name)
        else:
            ours = None if own.guide is None else getattr(own.guide, guided[name])
        assert (theirs is None) == (ours is None), name
        if theirs is None:
            continue
        ours, theirs = ours.numpy(), np.asarray(theirs)
        if name == "pq_bias":
            # the pad row's bias is each package's own sum over its codes:
            # the copied rows bit for bit, the encoded one to f32 rounding
            pad = np.asarray(jtier.global_ids) < 0
            assert np.array_equal(ours[~pad], theirs[~pad])
            np.testing.assert_allclose(ours[pad], theirs[pad], rtol=1e-6)
        else:
            assert np.array_equal(ours, theirs), name
    if mode == "bf16":
        assert np.array_equal(own.vectors_bf16.numpy(),
                              np.asarray(jtier.vectors_bf16).astype(np.float32))
    else:
        assert own.vectors_bf16 is None
    # the f32 set is never on a device: every placed array is the graph,
    # the ids or the compressed copy
    n_f32 = sum(t.numel() for row in (own.vectors_bf16.blocks if own.vectors_bf16 else ())
                for t in row if t.dtype == torch.float32)
    assert n_f32 == 0
    assert own.device_bytes()["cpu"] > 0


def test_search_matches_jax(setup, tiers):
    mode, jtier, carried, _ = tiers
    q, gt = setup["q"], setup["gt"]
    jd, ji, jst = jtier.search(q, search_width=48, k=10)
    td, ti, tst = carried.search(q, search_width=48, k=10)
    assert tst["search_type"] == jst["search_type"] == "sharded_host_tier"
    assert tst["mode"] == jst["mode"] and tst["n_shards"] == jst["n_shards"] == 4
    assert tst["pool_width"] == jst["pool_width"]
    assert ti.shape == ji.shape == (50, 10)
    assert (ti == ji).mean() >= 0.99
    assert abs(recall_at_k(ti, gt, 10) - recall_at_k(ji, gt, 10)) <= 0.002
    # the rerank is exact: the first distance is the true one
    d0 = ((q[0] - setup["pts"][ti[0, 0]]) ** 2).sum()
    np.testing.assert_allclose(td[0, 0], d0, rtol=1e-3)
    assert tst["rounds"] > 0 and tst["nodes_visited"] > 0


def test_search_pipelined_equals_search(setup, tiers):
    _, _, carried, own = tiers
    q = setup["q"]
    d_seq, i_seq, _ = own.search(q, search_width=32, k=10)
    d_pip, i_pip, st = own.search_pipelined(q, search_width=32, k=10, chunk=16)
    assert st["pipelined_chunks"] == 4
    assert np.array_equal(i_pip, i_seq) and np.array_equal(d_pip, d_seq)
    with pytest.raises(ValueError, match="divisible by the mesh data axis"):
        own.search_pipelined(q, search_width=32, k=10, chunk=15)


def test_guards(setup):
    pts = setup["pts"]
    idx = sharded_index_from_jax(setup["jidx"], device="cpu")
    reader = RecordReader(setup["path"], N, pts.shape[1], 0)
    mesh = make_mesh(n_shards=4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="unknown sharded host-tier mode"):
        ShardedHostTier.from_sharded_index(idx, reader, mesh, mode="int4")
    with pytest.raises(ValueError, match="needs pq model"):
        ShardedHostTier.from_sharded_index(idx, reader, mesh, mode="pq")
    _, tkw = _quantizer("residual", pts)
    with pytest.raises(ValueError, match="needs global pq_cells"):
        ShardedHostTier.from_sharded_index(idx, reader, mesh, mode="pq", pq=tkw["pq"],
                                           codes=tkw["codes"])
    import dataclasses

    cos = dataclasses.replace(idx, metric="cosine")
    with pytest.raises(ValueError, match="L2-only"):
        ShardedHostTier.from_sharded_index(cos, reader, mesh, **tkw)
