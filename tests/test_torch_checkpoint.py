"""The port's build checkpoints (`graph/checkpoint.py`) and its IVF kNN
backend (`graph/knn_build.py::approx_knn_ivf`, `build_vamana_knn(
knn_backend="ivf")`), held against the JAX package: the bf16 bit patterns
bit for bit against `ml_dtypes`, the dataset fingerprint equal to the JAX
package's for numpy and torch inputs, the JAX package's own checkpoint
cases (`tests/test_build_checkpoint.py`) mirrored, and checkpoints written
by either package resumed by the other. A port-built IVF draws its k-means
seeding from a `torch.Generator`, so the port's kNN tables are other
tables of the same quality: the IVF-backend graph is held to the recall of
the JAX IVF-backend graph at the same R."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.graph import checkpoint as jck
from diskrag_tpu.graph import knn_build as jkb
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.graph import knn_build as tkb
from diskrag_tpu_torch.graph.checkpoint import (
    BuildCheckpoint,
    dataset_fingerprint,
    pack_bf16,
    unpack_bf16,
)
from diskrag_tpu_torch.graph.search import beam_search


def _data(n=3000, d=32, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, d)).astype(np.float32) * 3
    return centers[rng.integers(0, 16, n)] + rng.normal(size=(n, d)).astype(np.float32)


def test_pack_bf16_bit_for_bit_against_ml_dtypes():
    rng = np.random.default_rng(0)
    every = rng.integers(0, 2**32, size=200_003, dtype=np.uint64).astype(np.uint32).view(np.float32)
    specials = np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 1.0000001, 3.3961e38,
                         3.4028235e38, 1e-45, -1e-40, 65504.0, 2.0**-126], np.float32)
    for a in (every, specials, np.tile(specials, 97)):  # scalar and vectorised conversions
        want = a.astype(ml_dtypes.bfloat16).view(np.uint16)
        got = pack_bf16(a)
        assert got.dtype == np.uint16 and np.array_equal(got, want)
        assert np.array_equal(got, jck.pack_bf16(a))
        back = unpack_bf16(got)
        assert back.dtype == np.float32
        assert np.array_equal(back.view(np.uint32), jck.unpack_bf16(want).view(np.uint32))
    # a 2-D table round-trips within bf16's precision
    t = _data(64)
    np.testing.assert_allclose(unpack_bf16(pack_bf16(t)), t, rtol=8e-3)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_dataset_fingerprint_equals_jax(kind):
    pts = _data(2050)
    given = torch.as_tensor(pts) if kind == "torch" else pts
    fp = dataset_fingerprint(given)
    assert fp == jck.dataset_fingerprint(pts) == jck.dataset_fingerprint(jnp.asarray(pts))
    assert fp == dataset_fingerprint(pts.copy())
    other = pts.copy()
    other[2, 0] += 1.0  # the strided sample holds row 2 at n = 2050
    assert dataset_fingerprint(torch.as_tensor(other) if kind == "torch" else other) != fp


def test_checkpoint_tag_invalidation(tmp_path):
    ck = BuildCheckpoint(tmp_path, tag={"seed": 0, "n": 10})
    ck.save("knn", ids=np.arange(4, dtype=np.int32))
    assert ck.has("knn")
    assert BuildCheckpoint(tmp_path, tag={"n": 10, "seed": 0}).has("knn")  # same tag, reordered
    # the JAX package reads the same tag file and keeps the phase
    assert jck.BuildCheckpoint(tmp_path, tag={"n": 10, "seed": 0}).has("knn")
    ck3 = BuildCheckpoint(tmp_path, tag={"n": 10, "seed": 1})
    assert not ck3.has("knn")
    assert json.loads((tmp_path / "tag.json").read_text())["seed"] == 1
    ck3.save("knn", ids=np.arange(3, dtype=np.int32))
    ck3.clear("knn")
    assert not ck3.has("knn")
    ck3.clear("knn")  # clearing an absent phase is a no-op


def test_corrupt_checkpoint_ignored(tmp_path):
    ck = BuildCheckpoint(tmp_path, tag={"x": 1})
    (tmp_path / "knn.npz").write_bytes(b"not an npz")
    assert ck.load("knn") is None
    ck.save("knn", ids=np.arange(4096, dtype=np.int32))
    full = (tmp_path / "knn.npz").read_bytes()
    (tmp_path / "knn.npz").write_bytes(full[: len(full) // 2])  # torn: BadZipFile
    assert ck.load("knn") is None
    assert ck.load("never_saved") is None


def test_phase_reader_matches_np_load(tmp_path):
    """The phase reader (members read whole at their offset, CRC-checked)
    returns what `np.load` returns, for every shape and layout a phase can
    hold; a flipped byte is caught by the CRC; compressed files are read
    through `np.load`."""
    from diskrag_tpu_torch.graph.checkpoint import _read_npz

    arrays = dict(ids=np.arange(4096 * 3, dtype=np.int32).reshape(4096, 3),
                  dists=pack_bf16(_data(50)), next_i=np.int64(7), empty=np.zeros((0, 5), np.float32),
                  fortran=np.asfortranarray(np.arange(12.0).reshape(3, 4)))
    ck = BuildCheckpoint(tmp_path, tag={"x": 1})
    ck.save("knn", **arrays)
    got = ck.load("knn")
    with np.load(tmp_path / "knn.npz") as z:
        assert sorted(got) == sorted(z.files)
        for k in z.files:
            assert got[k].dtype == z[k].dtype and got[k].shape == z[k].shape
            assert np.array_equal(got[k], z[k])
    assert got["fortran"].flags["F_CONTIGUOUS"] and int(got["next_i"]) == 7
    raw = bytearray((tmp_path / "knn.npz").read_bytes())
    raw[len(raw) // 3] ^= 1
    (tmp_path / "knn.npz").write_bytes(bytes(raw))
    assert ck.load("knn") is None
    np.savez_compressed(tmp_path / "knn.npz", ids=arrays["ids"])
    assert np.array_equal(_read_npz(tmp_path / "knn.npz")["ids"], arrays["ids"])


def test_orphan_phase_without_tag_is_dropped(tmp_path):
    ck = BuildCheckpoint(tmp_path, tag={"seed": 0})
    ck.save("knn", ids=np.arange(4, dtype=np.int32))
    (tmp_path / "knn_partial.npz.tmp").write_bytes(b"half a write")
    (tmp_path / "tag.json").unlink()
    ck2 = BuildCheckpoint(tmp_path, tag={"seed": 0})
    assert not ck2.has("knn") and not (tmp_path / "knn_partial.npz.tmp").exists()
    (tmp_path / "tag.json").write_text("{not json")  # an unreadable tag is a missing one
    ck2.save("knn", ids=np.arange(4, dtype=np.int32))
    assert not BuildCheckpoint(tmp_path, tag={"seed": 0}).has("knn")


def test_approx_knn_partial_resume_matches_fresh(tmp_path):
    pts = _data()
    vecs = torch.as_tensor(pts)
    k, qb = 16, 1024
    ids_fresh, dists_fresh = tkb.approx_knn_ivf(vecs, k, query_block=qb, seed=0, n_probe=4)
    assert ids_fresh.shape == dists_fresh.shape == (len(pts), k)
    assert ids_fresh.dtype == np.int32 and dists_fresh.dtype == np.float32
    assert not (ids_fresh == np.arange(len(pts))[:, None]).any()  # self excluded
    assert (np.diff(dists_fresh, axis=1) >= 0).all()
    ck = BuildCheckpoint(tmp_path, tag={"t": "partial"})
    ck.save("knn_partial", ids=ids_fresh[:qb], dists=pack_bf16(dists_fresh[:qb]),
            next_i=np.int64(qb), k=np.int64(k))
    ids_res, dists_res = tkb.approx_knn_ivf(vecs, k, query_block=qb, seed=0, n_probe=4,
                                            checkpoint=ck)
    np.testing.assert_array_equal(ids_res, ids_fresh)
    np.testing.assert_allclose(dists_res, dists_fresh, rtol=8e-3, atol=1e-4)
    assert ck.has("knn_partial")  # only the caller clears it, after saving "knn"
    # a partial of another k is not resumed
    ck.save("knn_partial", ids=ids_fresh[:qb, :8], dists=pack_bf16(dists_fresh[:qb, :8]),
            next_i=np.int64(qb), k=np.int64(8))
    ids_k, _ = tkb.approx_knn_ivf(vecs, k, query_block=qb, seed=0, n_probe=4, checkpoint=ck)
    np.testing.assert_array_equal(ids_k, ids_fresh)
    # partials are written as the pass goes
    ck2 = BuildCheckpoint(tmp_path / "every", tag={"t": "every"})
    tkb.approx_knn_ivf(vecs, k, query_block=qb, seed=0, n_probe=4, checkpoint=ck2,
                       checkpoint_every_s=0.0)
    part = ck2.load("knn_partial")
    assert int(part["next_i"]) == 3 * qb and part["ids"].shape == (len(pts), k)


def test_jax_written_partial_resumed_by_port(tmp_path):
    """A partial the JAX package wrote: the port takes its rows as they
    are and computes the rest with its own IVF (which gives the rows of
    its own fresh pass)."""
    pts = _data()
    k, qb = 16, 1024
    jids, jdists = jkb.approx_knn_ivf(jnp.asarray(pts), k, query_block=qb, seed=0, n_probe=4)
    jck.BuildCheckpoint(tmp_path, tag={"t": 1}).save(
        "knn_partial", ids=jids[:qb], dists=jck.pack_bf16(jdists[:qb]),
        next_i=np.int64(qb), k=np.int64(k))
    ck = BuildCheckpoint(tmp_path, tag={"t": 1})
    ids, dists = tkb.approx_knn_ivf(torch.as_tensor(pts), k, query_block=qb, seed=0, n_probe=4,
                                    checkpoint=ck)
    fresh_ids, _ = tkb.approx_knn_ivf(torch.as_tensor(pts), k, query_block=qb, seed=0, n_probe=4)
    np.testing.assert_array_equal(ids[:qb], jids[:qb])
    np.testing.assert_array_equal(dists[:qb], jck.unpack_bf16(jck.pack_bf16(jdists[:qb])))
    np.testing.assert_array_equal(ids[qb:], fresh_ids[qb:])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_completed_knn_phase_reused_across_packages(tmp_path, monkeypatch, writer):
    """The tag keys, the fingerprint and the files are the same in both
    packages: a "knn" phase either one saved is loaded by the other, whose
    own kNN pass then never runs."""
    pts = _data()
    kw = dict(degree_bound=16, knn_backend="ivf", knn_probe=4, checkpoint_dir=tmp_path)
    if writer == "jax":
        jkb.build_vamana_knn(pts, **kw)
    else:
        tkb.build_vamana_knn(pts, device="cpu", **kw)
    tag = json.loads((tmp_path / "tag.json").read_text())
    saved = dict(np.load(tmp_path / "knn.npz"))
    assert saved["dists"].dtype == np.uint16 and not (tmp_path / "knn_partial.npz").exists()

    def no_pass(*a, **k):
        raise AssertionError("the kNN pass ran although its phase was saved")

    if writer == "jax":
        monkeypatch.setattr(tkb, "approx_knn_ivf", no_pass)
        idx = tkb.build_vamana_knn(pts, device="cpu", **kw)
        assert idx.adjacency.shape == (len(pts), 16)
    else:
        monkeypatch.setattr(jkb, "approx_knn_ivf", no_pass)
        idx = jkb.build_vamana_knn(pts, **kw)
        assert np.asarray(idx.adjacency).shape == (len(pts), 16)
    assert json.loads((tmp_path / "tag.json").read_text()) == tag
    np.testing.assert_array_equal(np.load(tmp_path / "knn.npz")["ids"], saved["ids"])


def test_build_vamana_knn_checkpoint_reuse(tmp_path):
    pts = _data()
    stages = {}
    idx1 = tkb.build_vamana_knn(pts, degree_bound=16, knn_backend="ivf", knn_probe=4,
                                checkpoint_dir=tmp_path, checkpoint_every_s=0.0, device="cpu",
                                stage_seconds=stages)
    assert set(stages["knn_ivf_build"]) == {"fit", "assign", "place", "tiles"}
    assert (tmp_path / "knn.npz").exists()
    assert not (tmp_path / "knn_partial.npz").exists()  # cleared after the save
    idx2 = tkb.build_vamana_knn(pts, degree_bound=16, knn_backend="ivf", knn_probe=4,
                                checkpoint_dir=tmp_path, device="cpu")
    assert torch.equal(idx1.adjacency, idx2.adjacency)
    # without a checkpoint the same seeded build gives the same graph
    idx3 = tkb.build_vamana_knn(pts, degree_bound=16, knn_backend="ivf", knn_probe=4, device="cpu")
    assert torch.equal(idx1.adjacency, idx3.adjacency)
    tkb.build_vamana_knn(pts, degree_bound=16, knn_backend="ivf", knn_probe=8,
                         checkpoint_dir=tmp_path, device="cpu")
    assert json.loads((tmp_path / "tag.json").read_text())["knn_probe"] == 8
    # the flat backend ignores the directory, as in the JAX package
    tkb.build_vamana_knn(pts, degree_bound=16, knn_backend="flat",
                         checkpoint_dir=tmp_path / "flat", device="cpu")
    assert not (tmp_path / "flat").exists()


def test_host_resident_ivf_tables_give_the_same_graph(monkeypatch):
    pts = _data(1500)
    dev_built = tkb.build_vamana_knn(pts, degree_bound=12, knn_backend="ivf", device="cpu")
    monkeypatch.setattr(tkb, "_HOST_KNN_BYTES", 0)
    host_built = tkb.build_vamana_knn(pts, degree_bound=12, knn_backend="ivf", device="cpu")
    assert torch.equal(dev_built.adjacency, host_built.adjacency)


def test_ivf_backend_graph_recall_close_to_jax():
    pts = _data(4000)
    rng = np.random.default_rng(9)
    q = pts[rng.integers(0, len(pts), 200)] + rng.normal(size=(200, pts.shape[1])).astype(np.float32) * 0.3
    gt = ground_truth(pts, q, 10, device="cpu")
    r = 16
    ours = tkb.build_vamana_knn(pts, degree_bound=r, knn_backend="ivf", device="cpu")
    theirs = jkb.build_vamana_knn(pts, degree_bound=r, knn_backend="ivf")
    got = beam_search(ours.vectors, ours.adjacency, ours.medoid, torch.as_tensor(q),
                      search_width=32, k=10, entry_points=ours.entry_points)
    from diskrag_tpu.graph.search import beam_search as jax_beam_search

    want = jax_beam_search(theirs.vectors, theirs.adjacency, theirs.medoid, jnp.asarray(q),
                           search_width=32, k=10, entry_points=theirs.entry_points)
    rec_ours = recall_at_k(got.ids.numpy(), gt, 10)
    rec_theirs = recall_at_k(np.asarray(want.ids), gt, 10)
    assert abs(rec_ours - rec_theirs) <= 0.01, (rec_ours, rec_theirs)
