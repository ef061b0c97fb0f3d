"""The port's record reader (`diskrag_tpu_torch/native`): the copy of
`io_native.cpp` built by the port's own loader, held against its numpy
path and against the JAX package's reader on a record file the JAX
package wrote; the record files both packages write are byte-identical."""

import numpy as np
import pytest

from diskrag_tpu.index.persist import write_compat_records as jax_write_compat_records
from diskrag_tpu.native import RecordReader as JaxRecordReader

from diskrag_tpu_torch.index.persist import read_compat_records, write_compat_records
from diskrag_tpu_torch.kernels import _build
from diskrag_tpu_torch.native import RecordReader


@pytest.fixture(scope="module")
def record_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    n, dim, r = 500, 24, 8
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    adj = rng.integers(-1, n, size=(n, r)).astype(np.int32)
    path = tmp_path_factory.mktemp("native") / "index.dat"
    jax_write_compat_records(path, vecs, adj)
    return path, n, dim, r, vecs, adj


def test_record_files_of_both_packages_are_byte_identical(record_file, tmp_path):
    path, n, dim, r, vecs, adj = record_file
    assert write_compat_records(tmp_path / "index.dat", vecs, adj) == 4 * (dim + r)
    assert (tmp_path / "index.dat").read_bytes() == path.read_bytes()
    back_v, back_a = read_compat_records(path, n, dim, r)
    np.testing.assert_array_equal(back_v, vecs)
    np.testing.assert_array_equal(back_a, np.where(adj < 0, -1, adj))


def test_numpy_path_reader(record_file):
    path, n, dim, r, vecs, adj = record_file
    rd = RecordReader(path, n, dim, r, native=False)
    assert not rd.is_native
    v, nb = rd.get_nodes(np.asarray([0, 7, 499, -1, 600]))
    np.testing.assert_array_equal(v[0], vecs[0])
    np.testing.assert_array_equal(v[2], vecs[499])
    np.testing.assert_array_equal(nb[1], adj[7])
    assert (v[3] == 0).all() and (nb[3] == -1).all()
    assert (v[4] == 0).all() and (nb[4] == -1).all()
    assert rd.cache_stats() == {"hits": 0, "misses": 0, "native": False}


@pytest.mark.parametrize("n_threads", [1, 4])
def test_native_reader_matches_numpy_and_the_jax_reader(record_file, n_threads):
    path, n, dim, r, vecs, adj = record_file
    nat = RecordReader(path, n, dim, r, cache_capacity=4096)
    assert nat.is_native
    assert _build.host_lib_path(_build.NATIVE / "io_native.cpp").exists()
    ref = RecordReader(path, n, dim, r, native=False)
    jax_rd = JaxRecordReader(path, n, dim, r, cache_capacity=4096)

    ids = np.random.default_rng(1).integers(-2, n + 2, size=5000)
    # a batch >= capacity / 4 streams past the LRU (the rerank gather)
    v1, n1 = nat.get_nodes(ids, n_threads=n_threads)
    v2, n2 = ref.get_nodes(ids)
    v3, n3 = jax_rd.get_nodes(ids, n_threads=n_threads)
    for v, nb in ((v2, n2), (v3, n3)):
        np.testing.assert_array_equal(v1, v)
        np.testing.assert_array_equal(n1, nb)
    np.testing.assert_array_equal(nat.get_vectors(ids, n_threads=n_threads), v2)
    assert nat.cache_stats() == {"hits": 0, "misses": 0, "native": True}

    # small batches relative to the capacity go through the LRU
    a = nat.get_vectors(ids[:100])
    np.testing.assert_array_equal(a, v2[:100])
    np.testing.assert_array_equal(nat.get_vectors(ids[:100]), a)  # the second pass hits
    stats = nat.cache_stats()
    assert stats["native"] and stats["misses"] > 0 and stats["hits"] > 0
    nat.close()
    jax_rd.close()


def test_cache_stats_after_close_and_closed_reads(record_file):
    """cache_stats() after close() never hands the C library a NULL handle
    (it reports zeros); a gather after close raises instead of crashing."""
    path, n, dim, r, _, _ = record_file
    rd = RecordReader(path, n, dim, r)
    rd.get_vectors(np.arange(4))
    assert rd.cache_stats()["misses"] >= 0
    rd.close()
    assert rd.cache_stats() == {"hits": 0, "misses": 0, "native": False}
    with pytest.raises(RuntimeError, match="closed"):
        rd.get_vectors(np.arange(4))
    rd.close()  # idempotent


def test_native_path_raises_instead_of_falling_back(record_file, tmp_path, monkeypatch):
    """No quiet numpy fallback: a record file the reader cannot open, and a
    library that does not build, both raise."""
    path, n, dim, r, _, _ = record_file
    with pytest.raises(OSError, match="too short"):
        RecordReader(path, n + 1, dim, r)
    with pytest.raises(OSError, match="missing"):
        RecordReader(tmp_path / "absent.dat", n, dim, r)
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "io_native.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE", broken)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="failed to build"):
        RecordReader(path, n, dim, r)
    assert RecordReader(path, n, dim, r, native=False).get_vectors(np.arange(2)).shape == (2, dim)
