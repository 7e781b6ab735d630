"""The disk tier's native host runtime and vecs IO: the port's copies
(``spfresh_tpu_torch.native``, ``spfresh_tpu_torch.io``) against the JAX
package's and against their plain versions.  Twins of
``tests/test_native.py`` and of the vecs tests of ``tests/test_io_eval.py``.

Tolerances: none.  The gathers and readers copy bytes, so every comparison
is exact (``assert_array_equal``)."""

import gc

import numpy as np
import pytest

from spfresh_tpu import native as jnative
from spfresh_tpu.index.posting_store import write_packed_postings as j_write_packed
from spfresh_tpu.io import read_fvecs as j_read_fvecs
from spfresh_tpu.io import read_ivecs as j_read_ivecs
from spfresh_tpu.io import write_fvecs as j_write_fvecs
from spfresh_tpu_torch import native
from spfresh_tpu_torch.index.lazy import _gather_plain
from spfresh_tpu_torch.index.posting_store import read_packed_postings, write_packed_postings
from spfresh_tpu_torch.io import (
    read_bvecs,
    read_fvecs,
    read_ivecs,
    write_bvecs,
    write_fvecs,
    write_ivecs,
)
from spfresh_tpu_torch.io.vecs import read_vecs_plain


def _write_csr(tmp_path, rng, writer=write_packed_postings):
    path = str(tmp_path / "p.csr")
    offsets = np.array([0, 3, 5, 9], np.int64)
    ids = np.arange(100, 109, dtype=np.int64)
    vecs = rng.standard_normal((9, 4)).astype(np.float32)
    writer(path, [2, 5, 7], offsets, ids, vecs)
    return path, offsets, ids, vecs


# -- twins of tests/test_native.py -----------------------------------------


def test_native_csr_reads(tmp_path, rng):
    path, offsets, ids, vecs = _write_csr(tmp_path, rng)
    csr = native.NativeCsr(path)
    assert csr.num_clusters == 3
    assert csr.num_points == 9
    assert csr.dim == 4
    np.testing.assert_array_equal(csr.cluster_ids(), [2, 5, 7])
    got_ids, got_vecs = csr.posting(1)
    np.testing.assert_array_equal(got_ids, ids[3:5])
    np.testing.assert_array_equal(got_vecs, vecs[3:5])
    with pytest.raises(IndexError):
        csr.posting(3)
    csr.close()


def test_native_csr_posting_views_survive_reader_gc(tmp_path, rng):
    path, offsets, ids, vecs = _write_csr(tmp_path, rng)
    csr = native.NativeCsr(path)
    got_ids, got_vecs = csr.posting(2)
    del csr
    gc.collect()
    np.testing.assert_array_equal(got_ids, ids[5:9])
    np.testing.assert_array_equal(got_vecs, vecs[5:9])


def test_native_csr_gather_padded(tmp_path, rng):
    path, offsets, ids, vecs = _write_csr(tmp_path, rng)
    csr = native.NativeCsr(path)
    out_vecs, out_ids, out_lens = csr.gather_padded(np.array([2, 0]), pad=8)
    assert out_vecs.shape == (2, 8, 4)
    np.testing.assert_array_equal(out_lens, [4, 3])
    np.testing.assert_array_equal(out_vecs[0, :4], vecs[5:9])
    np.testing.assert_array_equal(out_ids[0, :4], ids[5:9])
    assert (out_ids[0, 4:] == -1).all()
    assert (out_vecs[1, 3:] == 0).all()
    csr.close()


def test_native_vecs_reader_matches_python(tmp_path, rng):
    arr = rng.standard_normal((23, 9)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    write_fvecs(p, arr)
    np.testing.assert_array_equal(native.read_vecs_native(p, "f"), arr)
    np.testing.assert_array_equal(read_vecs_plain(p, "f"), arr)
    ivec = rng.integers(0, 100, (7, 5)).astype(np.int32)
    pi = str(tmp_path / "x.ivecs")
    write_ivecs(pi, ivec)
    np.testing.assert_array_equal(native.read_vecs_native(pi, "i"), ivec)
    np.testing.assert_array_equal(read_vecs_plain(pi, "i"), ivec)


def test_native_async_gather_matches_sync(tmp_path, rng):
    path, offsets, ids, vecs = _write_csr(tmp_path, rng)
    csr = native.NativeCsr(path)
    want = csr.gather_padded(np.array([2, 0, 1]), pad=8)
    job = csr.gather_padded_async(np.array([2, 0, 1]), pad=8)
    got = job.join()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    job.join()  # idempotent
    bad = csr.gather_padded_async(np.array([99]), pad=8)
    with pytest.raises(IndexError):
        bad.join()
    csr.close()


# -- the native gather against the plain gather and the JAX package's ------


@pytest.mark.parametrize("pad", [3, 8, 40])
def test_native_gather_equals_plain_and_jax(tmp_path, pad):
    """A packed file of 50 postings of 0-37 rows: the native gather (sync
    and async, cut at ``pad``) equals the plain Python gather and the JAX
    package's native gather, byte for byte."""
    rng = np.random.default_rng(pad)
    lens = rng.integers(0, 38, 50)
    offsets = np.zeros(51, np.int64)
    np.cumsum(lens, out=offsets[1:])
    P = int(offsets[-1])
    ids = rng.permutation(10 * P)[:P].astype(np.int64)
    vecs = rng.standard_normal((P, 6)).astype(np.float32)
    path = str(tmp_path / "g.csr")
    write_packed_postings(path, np.arange(50) * 3, offsets, ids, vecs)
    rows = rng.integers(0, 50, 70)
    csr = native.NativeCsr(path)
    got = csr.gather_padded(rows, pad)
    got_async = csr.gather_padded_async(rows, pad).join()
    _, offs, mids, mvecs = read_packed_postings(path, mmap=True)
    want = _gather_plain(offs, mids, mvecs, rows, pad, 6)
    ref = jnative.NativeCsr(path).gather_padded(rows, pad)
    for g, ga, w, r in zip(got, got_async, want, ref):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(ga, w)
        np.testing.assert_array_equal(r, w)
    csr.close()


def test_native_reads_a_jax_written_file(tmp_path, rng):
    path, offsets, ids, vecs = _write_csr(tmp_path, rng, writer=j_write_packed)
    csr = native.NativeCsr(path)
    for i in range(3):
        got_ids, got_vecs = csr.posting(i)
        np.testing.assert_array_equal(got_ids, ids[offsets[i] : offsets[i + 1]])
        np.testing.assert_array_equal(got_vecs, vecs[offsets[i] : offsets[i + 1]])
    csr.close()


def test_native_rejects_a_non_packed_file(tmp_path):
    p = tmp_path / "junk.csr"
    p.write_bytes(b"NOTCSR\x00\x00" + b"\x00" * 32)
    with pytest.raises(ValueError):
        native.NativeCsr(str(p))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a build that cannot run raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "CXX", "no-such-compiler-for-spfresh")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SRC", broken)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()


# -- twins of the vecs tests of tests/test_io_eval.py ----------------------


def test_fvecs_roundtrip(tmp_path, rng):
    arr = rng.standard_normal((13, 7)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    write_fvecs(p, arr)
    out = read_fvecs(p)
    np.testing.assert_array_equal(out, arr)
    assert out.dtype == np.float32


def test_ivecs_roundtrip(tmp_path, rng):
    arr = rng.integers(0, 1000, size=(9, 10)).astype(np.int32)
    p = str(tmp_path / "gt.ivecs")
    write_ivecs(p, arr)
    out = read_ivecs(p)
    np.testing.assert_array_equal(out, arr)


def test_bvecs_roundtrip(tmp_path, rng):
    arr = rng.integers(0, 256, size=(11, 16)).astype(np.uint8)
    p = str(tmp_path / "x.bvecs")
    write_bvecs(p, arr)
    out = read_bvecs(p)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(read_vecs_plain(p, "b"), arr)


@pytest.mark.parametrize("reader", [read_fvecs, lambda p: read_vecs_plain(p, "f")],
                         ids=["native", "plain"])
def test_fvecs_rejects_garbage(tmp_path, reader):
    p = tmp_path / "bad.fvecs"
    p.write_bytes(b"\x03\x00\x00\x00" + b"\x00" * 7)  # truncated record
    with pytest.raises(ValueError):
        reader(str(p))


def test_vecs_rejects_mixed_record_dims(tmp_path):
    p = tmp_path / "mixed.fvecs"
    rec = lambda d: np.int32(d).tobytes() + np.zeros(d, np.float32).tobytes()  # noqa: E731
    p.write_bytes(rec(2) + np.int32(3).tobytes() + np.zeros(1, np.float32).tobytes() + rec(2))
    with pytest.raises(ValueError):
        read_fvecs(str(p))
    with pytest.raises(ValueError):
        read_vecs_plain(str(p), "f")


def test_missing_vecs_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_fvecs(str(tmp_path / "absent.fvecs"))


def test_vecs_files_cross_packages(tmp_path, rng):
    """Files written by either package read the same in the other."""
    arr = rng.standard_normal((17, 5)).astype(np.float32)
    gt = rng.integers(0, 10_000, size=(17, 10)).astype(np.int32)
    j_write_fvecs(str(tmp_path / "j.fvecs"), arr)
    write_fvecs(str(tmp_path / "t.fvecs"), arr)
    write_ivecs(str(tmp_path / "t.ivecs"), gt)
    assert (tmp_path / "j.fvecs").read_bytes() == (tmp_path / "t.fvecs").read_bytes()
    np.testing.assert_array_equal(read_fvecs(str(tmp_path / "j.fvecs")), arr)
    np.testing.assert_array_equal(j_read_fvecs(str(tmp_path / "t.fvecs")), arr)
    np.testing.assert_array_equal(j_read_ivecs(str(tmp_path / "t.ivecs")), gt)
