"""The port's sharded search racing live updates: twin of
tests/test_sharded_concurrent_stress.py.

A SEARCHER thread full-probes through the port's ``ShardedSpannIndex`` on
8 CPU shards while a MUTATOR drives ``SpFreshIndex`` inserts and deletes
(with Split, Merge and Reassign in the background) into the same index.
The sharded view refreshes in place from the index's mutation journal, so
each refresh reads postings that may be changing under it.

Assertions: no thread raises; no row repeats an id; a far-off anchor
vector that no mutation approaches stays its own top 1; no id whose delete
returned before a search began is served; after quiescing, the sharded
full probe returns the single-device result sets and no posting serves a
deleted id."""

import sys
import threading
import traceback

import numpy as np
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.lire import LireConfig, SpFreshIndex
from spfresh_tpu_torch.parallel import ShardedSpannIndex

torch.set_num_threads(2)

DIM = 8
# Mutation rounds: more than the JAX test's 40, so that the race spans
# many sharded-view refreshes.
ROUNDS = 160


def test_sharded_search_races_live_updates(tmp_path):
    rng = np.random.default_rng(0)
    data = 2.0 * rng.standard_normal((300, DIM)).astype(np.float32)
    data[0] = 50.0  # the anchor
    cfg = JConfig.from_dict({
        "clustering_params": {"initial_k": 4, "desired_cluster_size": 60, "rng_seed": 42},
        "output_path": str(tmp_path / "shc"),
    })
    jidx = JBuilder(cfg).with_data(data).build(save=False)
    index = from_jax_state(jidx.postings, jidx.centroids, jidx.dim, jidx.config.to_dict(),
                           device="cpu")
    fresh = SpFreshIndex(index, str(tmp_path / "shc_lire"),
                         lire_config=LireConfig(max_partition_size=120, min_partition_size=2))
    sharded = ShardedSpannIndex(index, ["cpu"] * 8)
    stop = threading.Event()
    errors = []
    deleted_lock = threading.Lock()
    deleted_confirmed: set = set()
    searches = [0]
    anchor_q = data[0][None, :]

    def searcher():
        try:
            qs = np.concatenate([anchor_q, data[5:9]], axis=0)
            while not stop.is_set():
                with deleted_lock:
                    dead = set(deleted_confirmed)
                ids, _ = sharded.search(qs, k=5, nprobe=index.num_clusters)
                for r in range(ids.shape[0]):
                    row = [i for i in ids[r].tolist() if i >= 0]
                    assert len(row) == len(set(row)), f"dup ids: {ids[r]}"
                assert ids[0, 0] == 0, f"anchor lost: {ids[0]}"
                hit_dead = dead & {int(i) for i in ids.ravel().tolist() if i >= 0}
                assert not hit_dead, f"deleted vids served: {hit_dead}"
                searches[0] += 1
        except Exception:  # noqa: BLE001 - surfaced through errors
            errors.append(("searcher", traceback.format_exc()))
            stop.set()

    def mutator():
        try:
            mrng = np.random.default_rng(1)
            next_vid = 10_000
            live_new = []
            for _ in range(ROUNDS):
                if stop.is_set():
                    return
                vecs = mrng.standard_normal((6, DIM)).astype(np.float32)
                for vid, v in zip(range(next_vid, next_vid + 6), vecs):
                    fresh.insert(v, vid)
                    live_new.append(vid)
                next_vid += 6
                if len(live_new) > 8:
                    doomed = [live_new.pop(0) for _ in range(4)]
                    fresh.delete_batch(doomed)
                    with deleted_lock:
                        deleted_confirmed.update(doomed)
        except Exception:  # noqa: BLE001
            errors.append(("mutator", traceback.format_exc()))
            stop.set()

    sharded.search(anchor_q, k=5, nprobe=index.num_clusters)  # pack the view first
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)  # switch threads often: more interleavings
    try:
        ts = threading.Thread(target=searcher)
        tm = threading.Thread(target=mutator)
        ts.start()
        tm.start()
        tm.join(timeout=120)
        stop.set()
        ts.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not tm.is_alive() and not ts.is_alive(), "a thread did not finish in time"
    assert not errors, errors[0][1]
    assert searches[0] > 0

    fresh.flush()
    qs = np.concatenate([anchor_q, data[20:26]], axis=0)
    ids_s, _ = sharded.search(qs, k=8, nprobe=index.num_clusters)
    ids_1, _ = index.search(qs, k=8, nprobe=index.num_clusters)
    for r in range(qs.shape[0]):
        assert set(ids_s[r].tolist()) == set(ids_1[r].tolist())
    with deleted_lock:
        dead = set(deleted_confirmed)
    for pid, (pids_, _vecs) in index.postings.items():
        assert not (set(int(i) for i in pids_.tolist()) & dead), (
            f"posting {pid} serves deleted vids")
    fresh.close()
