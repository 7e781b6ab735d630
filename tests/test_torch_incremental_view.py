"""In-place padded-view updates: one op sequence on a JAX ``SpannIndex`` and
on the port's (``from_jax_state``) must leave equal views after every
refresh (f32, bf16, int8), and the port's incrementally updated view must
search as a full repack of the same postings does."""

import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndex as JIndex
from spfresh_tpu_torch.index import Config, SpannIndex, brute_force_search
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

D = 32


def _count(name):
    return metrics.snapshot().get(name, 0)


def _pair(storage, n=240, clusters=6, seed=0):
    """A JAX index of ``clusters`` postings (add_cluster) and the port's
    copy of its host state."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, D)).astype(np.float32)
    raw = {"storage_dtype": storage}
    jidx = JIndex(JConfig.from_dict(raw))
    per = n // clusters
    for c in range(clusters):
        ids = np.arange(c * per, (c + 1) * per, dtype=np.int64)
        jidx.add_cluster(data[ids], ids, centroid=data[ids[0]].copy())
    port = from_jax_state(jidx.postings, jidx.centroids, jidx.dim, jidx.config.to_dict(),
                          device="cpu")
    return jidx, port, data, rng


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _assert_views_equal(port, jidx):
    pv, jv = port.padded_view(), jidx.padded_view()
    assert (pv.pad, pv.d_pad, pv.max_dup) == (jv.pad, jv.d_pad, jv.max_dup)
    assert pv.cluster_rows == jv.cluster_rows
    assert pv.free_rows == jv.free_rows
    assert sorted(pv.snapshot) == sorted(jv.snapshot)
    for c in jv.snapshot:
        np.testing.assert_array_equal(pv.snapshot[c], jv.snapshot[c])
    # Bit-equal: bf16 compares its exact f32 widening, int8 its codes.
    np.testing.assert_array_equal(pv.vectors3d.float().numpy(), _f32(jv.vectors3d))
    np.testing.assert_array_equal(pv.centroids.float().numpy(), _f32(jv.centroids))
    for name in ("ids2d", "lens", "cent_valid", "scales"):
        np.testing.assert_array_equal(getattr(pv, name).numpy(), np.asarray(getattr(jv, name)),
                                      err_msg=name)


def _assert_search_equal(port, jidx, queries, k=5):
    nprobe = port.num_clusters
    want_i, want_d = jidx.search(queries, k, nprobe=nprobe, engine="pallas")
    got_i, got_d = port.search(queries, k, nprobe=nprobe)
    np.testing.assert_array_equal(got_i, want_i)
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)  # f32 summation order


def _both(jidx, port, fn):
    fn(jidx)
    fn(port)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_op_sequence_views_equal_jax(storage):
    jidx, port, data, rng = _pair(storage)
    queries = data[::30] + 0.05
    _assert_views_equal(port, jidx)
    cids = sorted(jidx.postings)

    # 1. Appends near the centroid (within the slab's range: the int8
    #    append path keeps the slab's scale).
    c0 = cids[2]
    ids0, vecs0 = jidx.postings[c0]
    cent0 = jidx.centroids[c0]
    add = (cent0 + 0.1 * (vecs0[:3] - cent0)).astype(np.float32)
    appends0 = _count("view.append_updates")
    _both(jidx, port, lambda ix: ix.replace_posting(
        c0, np.append(ids0, [9000, 9001, 9002]), np.concatenate([vecs0, add])))
    _assert_views_equal(port, jidx)
    assert _count("view.append_updates") == appends0 + 1  # the port appended
    _assert_search_equal(port, jidx, queries)

    # 2. A delete in one posting and a removed posting.
    ids1, vecs1 = jidx.postings[cids[0]]
    keep = ids1 != ids1[3]
    _both(jidx, port, lambda ix: ix.replace_posting(cids[0], ids1[keep], vecs1[keep]))
    _both(jidx, port, lambda ix: ix.remove_cluster(cids[1]))
    _assert_views_equal(port, jidx)
    assert cids[1] not in port.padded_view().cluster_rows
    _assert_search_equal(port, jidx, queries)

    # 3. A new posting takes a free row of the same view.
    view = port.padded_view()
    nv = rng.standard_normal((4, D)).astype(np.float32)
    _both(jidx, port, lambda ix: ix.add_cluster(nv, np.arange(5000, 5004), centroid=nv[0].copy()))
    _assert_views_equal(port, jidx)
    assert port.padded_view() is view
    _assert_search_equal(port, jidx, np.concatenate([queries, nv[1:2]]))

    # 4. An append far outside a slab's range: int8 demotes it to a slab
    #    rewrite with a fresh scale; float storage appends.
    c3 = cids[3]
    ids3, vecs3 = jidx.postings[c3]
    far = (jidx.centroids[c3] + 40.0 * (vecs3[:1] - jidx.centroids[c3])).astype(np.float32)
    rows0 = _count("view.rows_scattered")
    _both(jidx, port, lambda ix: ix.replace_posting(
        c3, np.append(ids3, 9100), np.concatenate([vecs3, far])))
    _assert_views_equal(port, jidx)
    assert (_count("view.rows_scattered") > rows0) == (storage == "int8")
    _assert_search_equal(port, jidx, np.concatenate([queries, far]))

    # 5. A posting outgrows its slab: a full repack with a wider pad.
    pad = port.padded_view().pad
    ids4, vecs4 = jidx.postings[cids[4]]
    extra = rng.standard_normal((pad, D)).astype(np.float32)
    repacks0 = _count("view.full_repacks")
    _both(jidx, port, lambda ix: ix.replace_posting(
        cids[4], np.concatenate([ids4, np.arange(7000, 7000 + pad)]),
        np.concatenate([vecs4, extra])))
    _assert_views_equal(port, jidx)
    assert port.padded_view().pad > pad
    assert _count("view.full_repacks") == repacks0 + 1
    _assert_search_equal(port, jidx, np.concatenate([queries, extra[:2]]))


def _mk_index(rng, storage="float32", n=240, dim=32, clusters=6):
    data = rng.standard_normal((n, dim)).astype(np.float32)
    index = SpannIndex(Config.from_dict({"storage_dtype": storage}), device="cpu")
    per = n // clusters
    for c in range(clusters):
        ids = np.arange(c * per, (c + 1) * per, dtype=np.int64)
        index.add_cluster(data[ids], ids, centroid=data[ids[0]].copy())
    return index, data


def _search_after_full_repack(index, queries, k):
    """Search on a full repack of the same postings, then restore the
    incremental view."""
    view, gen = index._padded_view, index._padded_gen
    index.drop_device_views()
    try:
        return index.search(queries, k, nprobe=index.num_clusters)
    finally:
        index._padded_view, index._padded_gen = view, gen


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_insert_writes_in_place(storage):
    rng = np.random.default_rng(1)
    index, _ = _mk_index(rng, storage)
    v3 = index.padded_view().vectors3d
    before = _count("view.incremental_updates")
    cid = sorted(index.postings)[2]
    ids, vecs = index.postings[cid]
    nv = vecs.mean(axis=0).astype(np.float32)
    index.replace_posting(cid, np.append(ids, 9999), np.concatenate([vecs, nv[None]]))
    view = index.padded_view()
    assert _count("view.incremental_updates") == before + 1  # not a repack
    assert view.vectors3d is v3  # the same tensor, written in place
    q = nv[None, :] + 0.01
    got_i, got_d = index.search(q, k=5, nprobe=index.num_clusters)
    want_i, want_d = _search_after_full_repack(index, q, 5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    assert got_i[0, 0] == 9999


def test_delete_and_remove_cluster_in_place():
    rng = np.random.default_rng(2)
    index, data = _mk_index(rng)
    index.padded_view()
    cids = sorted(index.postings)
    ids, vecs = index.postings[cids[0]]
    victim = int(ids[3])
    index.replace_posting(cids[0], ids[ids != victim], vecs[ids != victim])
    gone = cids[1]
    gone_members = set(index.postings[gone][0].tolist())
    index.remove_cluster(gone)
    view = index.padded_view()
    assert gone not in view.cluster_rows
    got, _ = index.search(data[:16], k=8, nprobe=index.num_clusters)
    want, _ = _search_after_full_repack(index, data[:16], 8)
    np.testing.assert_array_equal(got, want)
    hit = set(got.ravel().tolist())
    assert victim not in hit and not (gone_members & hit)


def test_new_cluster_takes_free_row():
    rng = np.random.default_rng(3)
    index, _ = _mk_index(rng)
    v0 = index.padded_view()
    free_before = len(v0.free_rows)
    nv = rng.standard_normal((4, 32)).astype(np.float32)
    cid = index.add_cluster(nv, np.arange(5000, 5004), centroid=nv[0].copy())
    view = index.padded_view()
    assert view is v0  # the same view object, updated in place
    assert cid in view.cluster_rows
    assert len(view.free_rows) == free_before - 1
    got, _ = index.search(nv[2:3], k=1, nprobe=index.num_clusters)
    assert got[0, 0] == 5002


def test_slab_overflow_repacks_in_full():
    rng = np.random.default_rng(4)
    index, _ = _mk_index(rng)
    view = index.padded_view()
    pad = view.pad
    cid = sorted(index.postings)[0]
    ids, vecs = index.postings[cid]
    extra = rng.standard_normal((pad, 32)).astype(np.float32)
    repacks = _count("view.full_repacks")
    index.replace_posting(cid, np.concatenate([ids, np.arange(7000, 7000 + pad)]),
                          np.concatenate([vecs, extra]))
    view2 = index.padded_view()
    assert view2 is not view and view2.pad > pad
    assert _count("view.full_repacks") == repacks + 1
    got, _ = index.search(extra[0:1], k=1, nprobe=index.num_clusters)
    assert got[0, 0] == 7000


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_incremental_stream_full_probe_exact(storage):
    """A random stream of inserts and deletes; after each step the
    incrementally updated view returns the ids a full repack does, and for
    f32 storage the exact neighbours of the live corpus."""
    rng = np.random.default_rng(5)
    index, data = _mk_index(rng, storage, n=120, dim=16, clusters=4)
    live = {int(i): data[i] for i in range(120)}
    index.padded_view()
    next_id = 10_000
    for step in range(6):
        for _ in range(3):
            v = rng.standard_normal(16).astype(np.float32)
            cid = sorted(index.postings)[int(rng.integers(index.num_clusters))]
            ids, vecs = index.postings[cid]
            index.replace_posting(cid, np.append(ids, next_id), np.concatenate([vecs, v[None]]))
            live[next_id] = v
            next_id += 1
        for _ in range(2):
            cid = sorted(index.postings)[int(rng.integers(index.num_clusters))]
            ids, vecs = index.postings[cid]
            if len(ids) <= 1:
                continue
            j = int(rng.integers(len(ids)))
            live.pop(int(ids[j]), None)
            keep = np.arange(len(ids)) != j
            index.replace_posting(cid, ids[keep], vecs[keep])
        q = rng.standard_normal((4, 16)).astype(np.float32)
        got, _ = index.search(q, k=5, nprobe=index.num_clusters)
        want, _ = _search_after_full_repack(index, q, 5)
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        if storage == "float32":
            corpus_ids = np.array(sorted(live), np.int64)
            corpus = np.stack([live[int(i)] for i in corpus_ids])
            _, gt_rows = brute_force_search(corpus, q, k=5, device="cpu")
            for r in range(4):
                assert set(got[r].tolist()) == set(corpus_ids[gt_rows[r]].tolist()), step


def test_point_ids_must_fit_int32():
    rng = np.random.default_rng(6)
    index, _ = _mk_index(rng)
    index.padded_view()
    cid = sorted(index.postings)[0]
    ids, vecs = index.postings[cid]
    index.replace_posting(cid, np.append(ids, 2**31), np.concatenate([vecs, vecs[:1]]))
    with pytest.raises(ValueError, match="int32"):
        index.padded_view()
