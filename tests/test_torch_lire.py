"""LIRE storage and operations: the port's copies against the JAX package.
A store written by either package reopens in the other with the same
postings, versions, tombstones and centroids, and Split / Merge / Reassign
on identical stores leave identical stores."""

import shutil

import numpy as np
import pytest

from spfresh_tpu import lire as jl
from spfresh_tpu_torch import lire as tl
from spfresh_tpu_torch.lire.protocol import LireProtocol

DIM = 6


def _write_store(mod, path, seed=0):
    """The same op sequence through one package's LireStorage: imports,
    single and batched appends, tombstones, a cross-posting move, an
    atomic replace, a GC, and a WAL left unfolded at the end."""
    rng = np.random.default_rng(seed)
    st = mod.LireStorage(str(path), DIM)
    for pid in range(4):
        ids = np.arange(pid * 20, pid * 20 + 12, dtype=np.int64)
        vecs = rng.standard_normal((12, DIM)).astype(np.float32)
        st.import_posting(pid, ids, vecs, vecs.mean(axis=0))
    st.store_vector(1, 500, rng.standard_normal(DIM).astype(np.float32))
    st.store_vectors(2, [501, 502, 503], rng.standard_normal((3, DIM)).astype(np.float32))
    st.store_vectors_multi([0, 3, 3], [504, 505, 506],
                           rng.standard_normal((3, DIM)).astype(np.float32))
    st.mark_deleted(0, 3)
    st.mark_deleted_batch(2, [41, 42, 501, 9999])
    ids, _, vers = st.get_posting(1)
    st.move_vectors(1, 3, [int(ids[0]), int(ids[1])], [int(vers[0]), int(vers[1])])
    v0, v1 = st.get_posting_version(0), st.get_posting_version(1)
    i0, x0, _ = st.get_posting(0)
    i1, x1, _ = st.get_posting(1)
    assert st.atomic_replace([0, 1], [v0, v1], [
        (10, np.concatenate([i0, i1[:4]]), np.concatenate([x0, x1[:4]]), x0[0]),
        (11, i1[4:], x1[4:], x1[4])])
    for vid in (60, 61, 62, 63, 64, 65):
        st.mark_deleted(3, vid)
    st.collect_garbage(3)
    st.update_posting_centroid(2, np.full(DIM, 0.5, np.float32))
    st.store_vector(11, 507, rng.standard_normal(DIM).astype(np.float32))
    st.mark_deleted(10, 2)  # stays in the WAL: the store is not flushed
    return st


def _state(st, meta=True):
    """Everything a store answers: per posting its entries (tombstoned ones
    included) with their versions, live ids, count and centroid, and the
    reverse index.  ``meta`` adds the posting and store version counters,
    which a reopen recomputes from the entries."""
    out = {"pids": st.posting_ids()}
    for pid in st.posting_ids():
        ids, vecs, vers = st.get_posting(pid, include_deleted=True)
        live, _, _ = st.get_posting(pid)
        out[pid] = (ids.tolist(), vecs.tobytes(), vers.tolist(), live.tolist(),
                    st.get_vector_count(pid), st.get_posting_centroid(pid).tobytes())
        if meta:
            out[pid] += (st.get_posting_version(pid),)
    out["postings_of"] = {v: st.postings_of(v) for v in (5, 25, 500, 505, 42, 61, 2)}
    if meta:
        out["version"] = st.current_version()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_reopens_in_either_package(tmp_path, writer):
    mod = jl if writer == "jax" else tl
    written = _write_store(mod, tmp_path / "w")
    reopened = {}
    for reader in (jl, tl):
        path = tmp_path / f"copy_{reader.__name__.replace('.', '_')}"
        shutil.copytree(tmp_path / "w", path)  # opening folds the WAL: one copy each
        st = reader.LireStorage(str(path), DIM)
        assert _state(st, meta=False) == _state(written, meta=False), reader.__name__
        reopened[reader.__name__] = _state(st)
    assert reopened[tl.__name__] == reopened[jl.__name__]


def test_both_packages_write_identical_bytes(tmp_path):
    _write_store(jl, tmp_path / "j").flush()
    _write_store(tl, tmp_path / "t").flush()
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes(), f


class _Alloc:
    def __init__(self, start=100):
        self.next = start
        self.created, self.retired = [], []

    def __call__(self):
        self.next += 1
        return self.next - 1


def _ctx(mod, path, seed):
    """Identical stores in both packages: clustered postings with boundary
    vectors, so splits, merges and reassigns move something."""
    rng = np.random.default_rng(seed)
    st = mod.LireStorage(str(path), DIM)
    centers = rng.standard_normal((5, DIM)).astype(np.float32) * 4
    for pid in range(5):
        m = 8 if pid == 4 else 30
        vecs = (centers[pid] + rng.standard_normal((m, DIM))).astype(np.float32)
        if pid == 0:  # two blobs in one posting: a split separates them
            vecs[15:] += 6.0
        st.import_posting(pid, np.arange(pid * 100, pid * 100 + m), vecs, centers[pid])
    alloc = _Alloc()
    ctx = mod.LireContext(storage=st, alloc_posting_id=alloc,
                          on_posting_created=lambda pid, c: alloc.created.append(pid),
                          on_posting_retired=lambda pid: alloc.retired.append(pid))
    return ctx, st, alloc


def _ops(mod, st):
    ids1, _, vers1 = st.get_posting(1)
    return [
        mod.Split(0),
        mod.Merge(4, 3, max_size=200),
        mod.Reassign([(int(i), 1, int(v)) for i, v in zip(ids1, vers1)], [2, 3, 100, 101]),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_split_merge_reassign_leave_identical_stores(tmp_path, seed):
    results = {}
    for mod in (jl, tl):
        ctx, st, alloc = _ctx(mod, tmp_path / mod.__name__, seed)
        outs = []
        for op in _ops(mod, st):
            r = op.execute(ctx)
            outs.append((r.vectors_moved, r.new_postings, r.retired_postings))
        results[mod.__name__] = (outs, alloc.created, alloc.retired, _state(st))
    j, t = results[jl.__name__], results[tl.__name__]
    assert t == j
    outs = j[0]
    assert outs[0][1] and outs[1][1] and outs[2][0] > 0  # each op did something


def test_protocol_routes_as_jax(tmp_path):
    """Nearest partition, nearest other partition under a size budget and
    nearby postings agree with the JAX protocol (host route below
    DEVICE_ROUTE_MIN_C, and the port's device route forced on the CPU)."""
    _, jst, _ = _ctx(jl, tmp_path / "j", 2)
    _, tst, _ = _ctx(tl, tmp_path / "t", 2)
    jp = jl.LireProtocol(jst, jl.LireConfig(max_partition_size=40, min_partition_size=10))
    rng = np.random.default_rng(3)
    qs = rng.standard_normal((20, DIM)).astype(np.float32) * 4
    for device_min_c in (LireProtocol.DEVICE_ROUTE_MIN_C, 1):
        tp = tl.LireProtocol(tst, tl.LireConfig(max_partition_size=40, min_partition_size=10),
                             device="cpu")
        tp.DEVICE_ROUTE_MIN_C = device_min_c
        assert [tp.find_nearest_partition(q) for q in qs] == [jp.find_nearest_partition(q)
                                                              for q in qs]
        for pid in range(5):
            assert tp.get_nearby_postings(pid, 3) == jp.get_nearby_postings(pid, 3)
            assert tp._nearest_other_partition(pid, 25) == jp._nearest_other_partition(pid, 25)
            assert tp.needs_merge(pid) == jp.needs_merge(pid)
        assert (tp._route_cache[3] is None) == (device_min_c > 5)
