"""Twin of the single-device case of tests/test_view_update_fuzz.py.

The JAX test's random mutation sequences (member appends, slab rewrites
and shrinks, new and removed postings, centroid moves; its seeds and
corpora) run on a JAX ``SpannIndex`` and on the port's copy of it
(``from_jax_state``), whose view is updated in place.  Every few
mutations three full-probe searches return the same result sets: the
port's in-place view, a port view packed from scratch from the same
postings (the oracle), and the JAX package's in-place padded view; the
in-place view's distances equal the oracle's, and so do its nprobe-2
result sets (its centroids route alike).  Under
int8, after every step the port's view keeps its host copy of the scales
(``scales_host``, which the append path's scale guard reads) equal to its
device scales."""

import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.index import SpannIndex
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

DIM = 8


def _port_copy(index):
    return from_jax_state(index.postings, index.centroids, index.dim, index.config.to_dict(),
                          device="cpu")


def _sets_equal(a, b, ctx):
    assert a.shape == b.shape, ctx
    for r in range(a.shape[0]):
        assert set(a[r].tolist()) == set(b[r].tolist()), f"{ctx}: row {r} differs"


def _assert_scales_in_step(port, ctx):
    """The live view's host scales equal its device scales.  The view is
    read as it stands (refreshed only by the checks' searches), so the
    in-place refreshes batch mutations as the JAX test's do."""
    view = port._padded_view
    host = SpannIndex._view_scales_host(view)
    np.testing.assert_array_equal(host, view.scales.numpy(), err_msg=ctx)


@pytest.mark.parametrize("sd", ["float32", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 3])  # seed 3 caught the int8 append-scale divergence (r4)
def test_view_update_fuzz(tmp_path, sd, seed):
    rng = np.random.default_rng(5000 + seed)
    centers = 3.0 * rng.standard_normal((6, DIM)).astype(np.float32)
    data = (centers[rng.integers(0, 6, 300)]
            + 0.2 * rng.standard_normal((300, DIM))).astype(np.float32)
    cfg = Config.from_dict({
        "clustering_params": {"initial_k": 4, "desired_cluster_size": 50, "rng_seed": 42},
        "output_path": str(tmp_path / f"vf_{sd}_{seed}"),
        "storage_dtype": sd,
    })
    jidx = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    port = _port_copy(jidx)
    port.padded_view()  # packed before any mutation, so every refresh lands in place
    queries = np.concatenate([data[:6], 3.0 * rng.standard_normal((4, DIM))]).astype(
        np.float32)
    next_vid = 50_000
    in_place = metrics.snapshot().get("view.incremental_updates", 0)

    def do(fn):
        fn(jidx)
        fn(port)

    def check(ctx):
        k, npb = 8, jidx.num_clusters
        assert port.num_clusters == npb, ctx
        fresh = _port_copy(port)
        got, got_d = port.search(queries, k, nprobe=npb)
        oracle, oracle_d = fresh.search(queries, k, nprobe=npb)
        ref, _ = jidx.search(queries, k, nprobe=npb, engine="pallas")
        _sets_equal(got, oracle, f"{ctx} in-place-vs-fresh-pack")
        _sets_equal(got, np.asarray(ref), f"{ctx} port-vs-jax-padded")
        # Beyond the JAX test: the in-place slabs hold the fresh pack's
        # values (equal distances), and its centroids route alike (nprobe 2).
        np.testing.assert_array_equal(np.sort(got_d, axis=1), np.sort(oracle_d, axis=1),
                                      err_msg=ctx)
        _sets_equal(port.search(queries, k, nprobe=2)[0], fresh.search(queries, k, nprobe=2)[0],
                    f"{ctx} nprobe 2")

    check("initial")
    for step in range(40):
        op = rng.choice(["append", "rewrite", "shrink", "new", "remove", "centroid"],
                        p=[0.3, 0.15, 0.2, 0.12, 0.08, 0.15])
        cids = sorted(jidx.postings)
        if op == "append":
            c = int(rng.choice(cids))
            ids, vecs = jidx.postings[c]
            kk = int(rng.integers(1, 5))
            add = (jidx.centroids[c][None, :]
                   + 0.2 * rng.standard_normal((kk, DIM))).astype(np.float32)
            new_ids = np.concatenate([ids, np.arange(next_vid, next_vid + kk)])
            new_vecs = np.concatenate([np.asarray(vecs), add])
            cent = jidx.centroids[c]
            do(lambda ix: ix.replace_posting(c, new_ids, new_vecs, centroid=cent))
            next_vid += kk
        elif op == "rewrite":
            # A value change ships as a fresh id (ids' vectors are immutable).
            c = int(rng.choice(cids))
            ids, vecs = jidx.postings[c]
            ids, vecs = np.asarray(ids).copy(), np.asarray(vecs).copy()
            if len(ids):
                j = int(rng.integers(len(ids)))
                vecs[j] = vecs[j] + 0.05
                ids[j] = next_vid
                next_vid += 1
            do(lambda ix: ix.replace_posting(c, ids, vecs))
        elif op == "shrink":
            c = int(rng.choice(cids))
            ids, vecs = jidx.postings[c]
            if len(ids) > 2:
                keep = len(ids) - int(rng.integers(1, min(4, len(ids) - 1)))
                kept_ids, kept_vecs = ids[:keep], np.asarray(vecs)[:keep]
                do(lambda ix: ix.replace_posting(c, kept_ids, kept_vecs))
        elif op == "new":
            kk = int(rng.integers(2, 6))
            cent = 3.0 * rng.standard_normal(DIM).astype(np.float32)
            vs = (cent[None, :] + 0.2 * rng.standard_normal((kk, DIM))).astype(np.float32)
            do(lambda ix: ix.add_cluster(vs, np.arange(next_vid, next_vid + kk), cent))
            next_vid += kk
        elif op == "remove" and len(cids) > 3:
            c = int(rng.choice(cids))
            do(lambda ix: ix.remove_cluster(c))
        elif op == "centroid":
            c = int(rng.choice(cids))
            ids, vecs = jidx.postings[c]
            cent = (jidx.centroids[c] + 0.1 * rng.standard_normal(DIM)).astype(np.float32)
            do(lambda ix: ix.replace_posting(c, ids, vecs, centroid=cent))
        if sd == "int8":
            _assert_scales_in_step(port, f"seed={seed} step={step} {op}")
        if step % 6 == 5:
            check(f"sd={sd} seed={seed} step={step}")
    check(f"sd={sd} seed={seed} final")
    assert metrics.snapshot().get("view.incremental_updates", 0) > in_place
