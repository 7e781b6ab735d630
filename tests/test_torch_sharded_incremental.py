"""The sharded slab view updates in place on live mutations, as the JAX
package's does: one mutation sequence on a JAX ``SpannIndex`` and on the
port's copy (``from_jax_state``), each wrapped in its package's
``ShardedSpannIndex`` on 8 CPU devices, must leave equal sharded views
after every refresh (the same cid -> (shard, row) map, free rows and
snapshots, and per shard bit-equal slabs, ids, lengths, centroids, validity
and scales), the same ids from both sharded searches, and the result sets
of the port's single-device search (the oracle).  The view object stays the
same across refreshes that land in place; an overflow repacks."""

import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.parallel import ShardedSpannIndex as JSharded
from spfresh_tpu.parallel import default_mesh
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.parallel import ShardedSpannIndex
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

DIM = 8


class Pair:
    """A JAX index and the port's copy, driven by one op sequence."""

    def __init__(self, jidx):
        self.j = jidx
        self.p = from_jax_state(jidx.postings, jidx.centroids, jidx.dim,
                                jidx.config.to_dict(), device="cpu")
        self.jsh = JSharded(jidx, default_mesh(), engine="pallas")
        self.psh = ShardedSpannIndex(self.p, ["cpu"] * 8)
        # Both views packed before any mutation, so both refresh in place.
        self.jsh.padded_view()
        self.psh.padded_view()

    def do(self, fn):
        fn(self.j)
        fn(self.p)

    @property
    def postings(self):
        return self.j.postings

    @property
    def centroids(self):
        return self.j.centroids


def _pair(tmp_path, rng, n=400, cap=40, storage="float32", data=None):
    if data is None:
        data = rng.standard_normal((n, DIM)).astype(np.float32)
    cfg = JConfig.from_dict({
        "clustering_params": {"initial_k": 4, "desired_cluster_size": cap, "rng_seed": 42},
        "output_path": str(tmp_path / "idx"),
        "storage_dtype": storage,
    })
    return Pair(JBuilder(cfg).with_data(data).build(save=False)), data


def _count(name):
    return metrics.snapshot().get(name, 0)


def _assert_views_equal(pair):
    pv, jv = pair.psh.padded_view(), pair.jsh.padded_view()
    assert (pv.pad, pv.d_pad, pv.max_dup, pv.scratch_row, pv.num_shards) == (
        jv.pad, jv.d_pad, jv.max_dup, jv.scratch_row, jv.num_shards)
    assert pv.cluster_rows == jv.cluster_rows
    assert pv.free_rows == jv.free_rows
    assert sorted(pv.snapshot) == sorted(jv.snapshot)
    for c in jv.snapshot:
        np.testing.assert_array_equal(pv.snapshot[c], jv.snapshot[c])
    for s, v in enumerate(pv.shards):
        assert v.max_dup == pv.max_dup
        # Bit-equal: bf16 compares its exact f32 widening, int8 its codes.
        np.testing.assert_array_equal(
            v.vectors3d.float().numpy(), np.asarray(jv.vectors3d[s]).astype(np.float32))
        np.testing.assert_array_equal(
            v.centroids.float().numpy(), np.asarray(jv.centroids[s]).astype(np.float32))
        for name in ("ids2d", "lens", "cent_valid", "scales"):
            np.testing.assert_array_equal(getattr(v, name).numpy(),
                                          np.asarray(getattr(jv, name)[s]),
                                          err_msg=f"shard {s} {name}")


def _single(pair, queries, k, npb):
    """Both packages' single-device full probe (the oracle); each packs its
    own view, which raises its index's multiplicity hint alike."""
    ids_1, _ = pair.p.search(queries, k=k, nprobe=npb)
    ids_j1, _ = pair.j.search(queries, k=k, nprobe=npb, engine="pallas")
    np.testing.assert_array_equal(ids_1, ids_j1)
    return ids_1


def _assert_matches_oracle(pair, queries, k=10):
    """Both sharded searches give the same ids; the port's gives the result
    sets of the single-device full probe."""
    npb = pair.p.num_clusters
    ids_s, d_s = pair.psh.search(queries, k=k, nprobe=npb)
    ids_j, d_j = pair.jsh.search(queries, k=k, nprobe=npb)
    np.testing.assert_array_equal(ids_s, ids_j)
    fin = np.isfinite(d_j)
    np.testing.assert_allclose(d_s[fin], d_j[fin], rtol=1e-5)  # f32 summation order
    ids_1 = _single(pair, queries, k, npb)
    for r in range(queries.shape[0]):
        assert set(ids_s[r].tolist()) == set(ids_1[r].tolist())


def _append(pair, c, add, new_ids, **kw):
    ids, vecs = pair.postings[c]
    pair.do(lambda ix: ix.replace_posting(
        c, np.concatenate([ids, new_ids]), np.concatenate([np.asarray(vecs), add]), **kw))


def test_append_path_no_rebuild(tmp_path, rng):
    pair, _ = _pair(tmp_path, rng)
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    view0 = pair.psh.padded_view()
    _assert_views_equal(pair)
    repacks, appends = _count("view.full_repacks"), _count("view.append_updates")
    next_id = 50_000
    cids = sorted(pair.postings)[:3]
    for c in cids:
        _append(pair, c, rng.standard_normal((3, DIM)).astype(np.float32),
                np.arange(next_id, next_id + 3))
        next_id += 3
    assert pair.psh.padded_view() is view0, "append should land in place, not rebuild"
    assert _count("view.append_updates") == appends + 1
    assert _count("view.full_repacks") == repacks
    _assert_views_equal(pair)
    _assert_matches_oracle(pair, q)
    hit, _ = pair.psh.search(pair.p.postings[cids[0]][1][-1][None, :], k=1,
                             nprobe=pair.p.num_clusters)
    assert hit[0, 0] == pair.p.postings[cids[0]][0][-1]


def test_rewrite_and_new_posting_no_rebuild(tmp_path, rng):
    pair, _ = _pair(tmp_path, rng)
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    view0 = pair.psh.padded_view()
    rows0, repacks = _count("view.rows_scattered"), _count("view.full_repacks")
    # A shrink (slab rewrite), a new posting on a free row, a removal.
    c0 = sorted(pair.postings)[0]
    ids, vecs = pair.postings[c0]
    pair.do(lambda ix: ix.replace_posting(c0, ids[:-2], np.asarray(vecs)[:-2]))
    nv = rng.standard_normal((5, DIM)).astype(np.float32)
    pair.do(lambda ix: ix.add_cluster(nv, np.arange(60_000, 60_005), nv.mean(axis=0)))
    c1 = sorted(pair.postings)[1]
    removed_ids = set(pair.postings[c1][0].tolist())
    pair.do(lambda ix: ix.remove_cluster(c1))
    assert pair.psh.padded_view() is view0, "rewrites should land in place, not rebuild"
    assert _count("view.rows_scattered") == rows0 + 3
    assert _count("view.full_repacks") == repacks
    _assert_views_equal(pair)
    assert c1 not in view0.cluster_rows
    _assert_matches_oracle(pair, q)
    hit, _ = pair.psh.search(nv, k=1, nprobe=pair.p.num_clusters)
    assert set(hit[:, 0].tolist()) <= set(range(60_000, 60_005))
    all_ids, _ = pair.psh.search(q, k=10, nprobe=pair.p.num_clusters)
    exclusive = removed_ids - {
        i for pids, _ in pair.p.postings.values() for i in pids.tolist()}
    assert not (set(all_ids.ravel().tolist()) & exclusive)


def test_overflow_falls_back_to_rebuild(tmp_path, rng):
    pair, _ = _pair(tmp_path, rng)
    view0 = pair.psh.padded_view()
    repacks = _count("view.full_repacks")
    c0 = sorted(pair.postings)[0]
    grow = view0.pad + 8 - len(pair.postings[c0][0])
    _append(pair, c0, rng.standard_normal((grow, DIM)).astype(np.float32),
            np.arange(70_000, 70_000 + grow))
    view1 = pair.psh.padded_view()
    assert view1 is not view0
    assert view1.pad >= view0.pad + 8
    assert _count("view.full_repacks") == repacks + 1
    _assert_views_equal(pair)
    _assert_matches_oracle(pair, rng.standard_normal((4, DIM)).astype(np.float32))


def test_free_rows_exhausted_repacks_with_clean_snapshot(tmp_path, rng):
    """More new postings than free rows, with an append planned first: the
    refresh gives up and repacks, in both packages at the same mutation,
    and the repacked view holds every posting."""
    pair, _ = _pair(tmp_path, rng)
    view0 = pair.psh.padded_view()
    repacks = _count("view.full_repacks")
    c0 = sorted(pair.postings)[0]
    _append(pair, c0, rng.standard_normal((2, DIM)).astype(np.float32),
            np.arange(80_000, 80_002))
    n_new = sum(len(f) for f in view0.free_rows) + 1
    for j in range(n_new):
        nv = rng.standard_normal((2, DIM)).astype(np.float32)
        pair.do(lambda ix: ix.add_cluster(nv, np.arange(90_000 + 2 * j, 90_002 + 2 * j),
                                          nv[0]))
    view1 = pair.psh.padded_view()
    assert view1 is not view0
    assert _count("view.full_repacks") == repacks + 1
    _assert_views_equal(pair)
    _assert_matches_oracle(pair, rng.standard_normal((4, DIM)).astype(np.float32))


def test_randomized_mutation_interleaving_matches_oracle(tmp_path, rng):
    """Random interleavings of appends, shrinks, new postings, removals and
    overflow-forcing growths: after every round the views are equal and
    the searches agree, including rounds whose planning gives up halfway
    into a repack (the deferred append snapshots)."""
    pair, _ = _pair(tmp_path, rng)
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    next_id = 100_000
    for _ in range(8):
        cids = sorted(pair.postings)
        op = int(rng.integers(0, 4))
        if op == 0:  # appends to a few postings
            for c in rng.choice(cids, size=min(3, len(cids)), replace=False):
                m = int(rng.integers(1, 4))
                _append(pair, int(c), rng.standard_normal((m, DIM)).astype(np.float32),
                        np.arange(next_id, next_id + m))
                next_id += m
        elif op == 1:  # shrink one, grow another in the same dirty set
            c0, c1 = int(cids[0]), int(cids[-1])
            ids, vecs = pair.postings[c0]
            if len(ids) > 2:
                pair.do(lambda ix: ix.replace_posting(c0, ids[:-2], np.asarray(vecs)[:-2]))
            _append(pair, c1, rng.standard_normal((2, DIM)).astype(np.float32),
                    np.arange(next_id, next_id + 2))
            next_id += 2
        elif op == 2:  # new posting + remove an old one
            nv = rng.standard_normal((4, DIM)).astype(np.float32)
            pair.do(lambda ix: ix.add_cluster(nv, np.arange(next_id, next_id + 4),
                                              nv.mean(axis=0)))
            next_id += 4
            if len(cids) > 3:
                pair.do(lambda ix: ix.remove_cluster(int(cids[1])))
        else:  # overflow: outgrow the slab width mid-plan
            view = pair.psh.padded_view()
            c0 = int(cids[int(rng.integers(0, len(cids)))])
            grow = view.pad + 4 - len(pair.postings[c0][0])
            if grow > 0:
                _append(pair, c0, rng.standard_normal((grow, DIM)).astype(np.float32),
                        np.arange(next_id, next_id + grow))
                next_id += grow
        _assert_views_equal(pair)
        _assert_matches_oracle(pair, q)


def test_int8_sharded_incremental_updates(tmp_path, rng):
    """int8 residual slabs: appends quantize with the slab's existing scale,
    a rewrite (delete) recomputes the scale, and each shard's host scales
    stay in step with its device scales."""
    centers = 3.0 * rng.standard_normal((8, DIM)).astype(np.float32)
    data = (centers[rng.integers(0, 8, 400)]
            + 0.2 * rng.standard_normal((400, DIM))).astype(np.float32)
    pair, _ = _pair(tmp_path, rng, storage="int8", data=data)
    q = data[:6]
    view0 = pair.psh.padded_view()
    _assert_views_equal(pair)
    _assert_matches_oracle(pair, q)
    cids = sorted(pair.postings)[:2]
    next_id = 50_000
    for c in cids:
        add = (pair.centroids[c][None, :] + 0.1 * rng.standard_normal((3, DIM))).astype(
            np.float32)
        _append(pair, c, add, np.arange(next_id, next_id + 3))
        next_id += 3
    assert pair.psh.padded_view() is view0, "append should land in place, not rebuild"
    _assert_views_equal(pair)
    _assert_matches_oracle(pair, q)
    c0 = cids[0]
    ids0, vecs0 = pair.postings[c0]
    pair.do(lambda ix: ix.replace_posting(c0, ids0[:-5], np.asarray(vecs0)[:-5]))
    assert pair.psh.padded_view() is view0
    _assert_views_equal(pair)
    _assert_matches_oracle(pair, q)
    for v in view0.shards:
        if v.scales_host is not None:
            np.testing.assert_array_equal(v.scales_host, v.scales.numpy())
    v = np.asarray(pair.p.postings[cids[1]][1])[-1]
    hit, d = pair.psh.search(v[None, :], k=1, nprobe=pair.p.num_clusters)
    assert hit[0, 0] == pair.p.postings[cids[1]][0][-1]
    assert float(d[0, 0]) < 0.02


@pytest.mark.parametrize("sd", ["float32", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_view_update_fuzz(tmp_path, sd, seed):
    """Twin of the sharded case of tests/test_view_update_fuzz.py: random
    appends, rewrites, shrinks, new and removed postings and centroid moves;
    every few steps the sharded views are equal and the sharded global-mode
    full probe returns the single-device result sets, in both packages."""
    rng = np.random.default_rng(5000 + seed)
    centers = 3.0 * rng.standard_normal((6, DIM)).astype(np.float32)
    data = (centers[rng.integers(0, 6, 300)]
            + 0.2 * rng.standard_normal((300, DIM))).astype(np.float32)
    pair, _ = _pair(tmp_path, rng, cap=50, storage=sd, data=data)
    queries = np.concatenate([data[:6], 3.0 * rng.standard_normal((4, DIM))]).astype(
        np.float32)
    next_vid = 50_000

    def check(ctx):
        npb = pair.p.num_clusters
        _assert_views_equal(pair)
        ids_1 = _single(pair, queries, 8, npb)
        ids_s, _ = pair.psh.search(queries, 8, nprobe=npb, nprobe_mode="global")
        ids_j, _ = pair.jsh.search(queries, 8, nprobe=npb, nprobe_mode="global")
        np.testing.assert_array_equal(ids_s, ids_j, err_msg=ctx)
        for r in range(queries.shape[0]):
            assert set(ids_s[r].tolist()) == set(ids_1[r].tolist()), f"{ctx}: row {r}"

    check("initial")
    for step in range(40):
        op = rng.choice(["append", "rewrite", "shrink", "new", "remove", "centroid"],
                        p=[0.3, 0.15, 0.2, 0.12, 0.08, 0.15])
        cids = sorted(pair.postings)
        if op == "append":
            c = int(rng.choice(cids))
            kk = int(rng.integers(1, 5))
            add = (pair.centroids[c][None, :]
                   + 0.2 * rng.standard_normal((kk, DIM))).astype(np.float32)
            _append(pair, c, add, np.arange(next_vid, next_vid + kk),
                    centroid=pair.centroids[c])
            next_vid += kk
        elif op == "rewrite":
            # A value change ships as a fresh id (ids' vectors are immutable).
            c = int(rng.choice(cids))
            ids, vecs = pair.postings[c]
            ids, vecs = np.asarray(ids).copy(), np.asarray(vecs).copy()
            if len(ids):
                j = int(rng.integers(len(ids)))
                vecs[j] = vecs[j] + 0.05
                ids[j] = next_vid
                next_vid += 1
            pair.do(lambda ix: ix.replace_posting(c, ids, vecs))
        elif op == "shrink":
            c = int(rng.choice(cids))
            ids, vecs = pair.postings[c]
            if len(ids) > 2:
                keep = len(ids) - int(rng.integers(1, min(4, len(ids) - 1)))
                pair.do(lambda ix: ix.replace_posting(c, ids[:keep], np.asarray(vecs)[:keep]))
        elif op == "new":
            kk = int(rng.integers(2, 6))
            cent = 3.0 * rng.standard_normal(DIM).astype(np.float32)
            vs = (cent[None, :] + 0.2 * rng.standard_normal((kk, DIM))).astype(np.float32)
            pair.do(lambda ix: ix.add_cluster(vs, np.arange(next_vid, next_vid + kk), cent))
            next_vid += kk
        elif op == "remove" and len(cids) > 3:
            c = int(rng.choice(cids))
            pair.do(lambda ix: ix.remove_cluster(c))
        elif op == "centroid":
            c = int(rng.choice(cids))
            ids, vecs = pair.postings[c]
            cent = (pair.centroids[c] + 0.1 * rng.standard_normal(DIM)).astype(np.float32)
            pair.do(lambda ix: ix.replace_posting(c, ids, vecs, centroid=cent))
        if step % 6 == 5:
            check(f"sd={sd} seed={seed} step={step}")
    check(f"sd={sd} seed={seed} final")


def test_refresh_takes_a_mutation_in_flight_next_time(tmp_path, rng):
    """A refresh that runs while a mutation has changed its posting but not
    yet marked it in the journal (as a search racing SpFreshIndex can)
    must not count that mutation as landed: the next refresh writes it."""
    pair, _ = _pair(tmp_path, rng)
    index, sharded = pair.p, pair.psh
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    c = sorted(index.postings)[0]
    ids, vecs = index.postings[c]
    gone = set(ids[-3:].tolist()) - {
        i for cc, (pids, _) in index.postings.items() if cc != c for i in pids.tolist()}
    # replace_posting, stopped between its posting change and _mark_dirty.
    index.postings[c] = (ids[:-3], np.asarray(vecs)[:-3])
    index._gen += 1
    sharded.padded_view()
    index._mutated_gen[c] = index._gen
    index._dirty_padded.add(c)
    npb = index.num_clusters
    got, _ = sharded.search(np.concatenate([q, np.asarray(vecs)[-3:]]), 10, nprobe=npb)
    want, _ = index.search(np.concatenate([q, np.asarray(vecs)[-3:]]), 10, nprobe=npb)
    for r in range(len(got)):
        assert set(got[r].tolist()) == set(want[r].tolist())
    assert gone and not (set(got.ravel().tolist()) & gone)
