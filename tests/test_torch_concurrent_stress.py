"""Twin of tests/test_concurrent_stress.py: threaded stress over the port's
serving stacks on the CPU, for a bounded wall.

Disk tier (``LazySpFreshIndex``), one parametrised test:
  * ``compactor_thread`` — the JAX test's actors (``:54``): two searchers
    running full probes nonstop (so routing refreshes race each other), a
    mutator interleaving inserts, deletes and batch deletes, and a
    compactor on a thread of its own, for 8 s;
  * ``inline_compact`` — eight searchers (prefetch pipeline on, batches of
    8) against one writer that inserts hot-spot batches (so Split runs),
    deletes part of each and compacts inline, with a short switch
    interval, for 3 s.
RAM tier (``SpFreshIndex``, ``:195``): a searcher against a mutator under
continuous background splits, for 6 s.

The JAX test's assertions hold in each: no thread raises or wedges; no
vid whose delete returned before a search began is returned by it; a
resident vid (the anchor) stays findable; and after the stress the
flushed live set equals the model's (the build's ids, plus every insert,
less every confirmed delete), the anchor exact at full probe.  No result
row repeats an id.  Failures carry ``_vid_state``'s forensics, captured
at detection time."""

import sys
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.lire import LireConfig, LireStorageError
from spfresh_tpu_torch.lire.fresh import SpFreshIndex
from spfresh_tpu_torch.lire.lazy_fresh import LazySpFreshIndex
from test_concurrent_stress import _vid_state

torch.set_num_threads(2)

DIM = 8


def _live_ids(storage):
    return {int(v) for pid in storage.posting_ids() for v in storage.get_posting(pid)[0]}


class Stress:
    """Shared state of one stress run: the deletes confirmed so far, the
    inserts, and the errors every actor reports."""

    def __init__(self, fresh, data):
        self.fresh, self.data = fresh, data
        self.stop = threading.Event()
        self.errors = []
        self.lock = threading.Lock()
        self.deleted = set()  # vids whose delete() has returned
        self.inserted = set()

    def fail(self, msg, vids):
        self.errors.append(f"{msg} | {_vid_state(self.fresh, vids)}")

    def actor(self, name, body):
        def run():
            try:
                body()
            except Exception as e:  # noqa: BLE001 — reported with its trace
                self.errors.append(f"{name} raised: {type(e).__name__}: {e}\n"
                                   f"{traceback.format_exc()}")
        return threading.Thread(target=run, name=name)

    def searcher(self, q, k, nprobe, **kw):
        """Searches ``q`` (row 0 the anchor, vid 0) until stopped."""
        def body():
            while not self.stop.is_set():
                # Only vids whose delete returned before this search started
                # must be absent; an overlapping delete may race it.
                with self.lock:
                    pre = set(self.deleted)
                ids, _ = self.fresh.search(q, k, nprobe=nprobe(), **kw)
                for row in ids:
                    real = [int(i) for i in row if i >= 0]
                    if len(real) != len(set(real)):
                        return self.fail(f"repeated id in a row: {row}", real)
                bad = set(ids.reshape(-1).tolist()) & pre
                if bad:
                    return self.fail(f"deleted vids in results: {bad}", bad)
                if 0 not in ids[0]:
                    return self.fail("anchor vid vanished from its own query", [0])
        return body

    def delete(self, vid) -> bool:
        for _ in range(20):
            try:
                self.fresh.delete(vid)
                break
            except LireStorageError:
                continue  # the documented retry contract
        else:
            self.fail(f"delete({vid}) never converged", [vid])
            return False
        with self.lock:
            self.deleted.add(vid)
        return True

    def random_mutator(self, first_vid):
        """The JAX test's mutator: inserts, deletes and batch deletes of
        its own vids."""
        def body():
            r = np.random.default_rng(1)
            next_vid, mine = first_vid, []
            while not self.stop.is_set():
                if mine and r.random() < 0.45:
                    if len(mine) >= 3 and r.random() < 0.3:
                        # The zero-hit-round and stale-mirror-sweep paths.
                        vids = [mine.pop(int(r.integers(len(mine)))) for _ in range(3)]
                        n_del = self.fresh.delete_batch(vids)
                        confirmed = [v for v in vids if not self.fresh.storage.postings_of(v)]
                        if n_del < len(vids) and len(confirmed) == len(vids):
                            return self.fail(f"delete_batch({vids}) undercounted {n_del}", vids)
                        with self.lock:
                            self.deleted.update(confirmed)
                        mine.extend(v for v in vids if v not in confirmed)
                        continue
                    if not self.delete(mine.pop(int(r.integers(len(mine))))):
                        return
                else:
                    v = 2.0 * r.standard_normal(DIM).astype(np.float32)
                    self.fresh.insert(v, next_vid)
                    self.inserted.add(next_vid)
                    mine.append(next_vid)
                    next_vid += 1
        return body

    def hot_spot_writer(self, rng, rounds):
        """Hot-spot batches of 30 near one of three postings, 5 of each
        deleted, a compaction every 4 batches."""
        def body():
            vid, r = 20_000, 0
            while not self.stop.is_set() and not self.errors:
                pid = self.fresh.storage.posting_ids()[r % 3]
                cent = self.fresh.storage.get_posting_centroid(pid)
                add = (cent[None, :] + 0.01 * rng.standard_normal((30, DIM))).astype(np.float32)
                self.fresh.insert_batch(add, np.arange(vid, vid + 30))
                self.inserted.update(range(vid, vid + 30))
                victims = [int(v) for v in rng.choice(np.arange(vid, vid + 30), 5, replace=False)]
                self.fresh.delete_batch(victims)
                with self.lock:
                    self.deleted.update(victims)
                vid += 30
                r += 1
                rounds[0] = r
                if r % 4 == 0:
                    self.fresh.compact()
        return body

    def compactor(self):
        def body():
            while not self.stop.is_set():
                self.fresh.compact()
                self.stop.wait(0.25)
        return body

    def run(self, threads, wall, switch=None):
        old = sys.getswitchinterval()
        if switch is not None:
            sys.setswitchinterval(switch)
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + wall
            while time.monotonic() < deadline and not self.errors:
                time.sleep(0.05)
        finally:
            self.stop.set()
            for t in threads:
                t.join(60)
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads), "stress thread wedged (deadlock)"
        assert not self.errors, self.errors[:3]

    def assert_final(self, initial, nprobe):
        """Flushed: the live set is the model's, the anchor exact."""
        self.fresh.flush()
        ids, d = self.fresh.search(self.data[:1], 1, nprobe=nprobe())
        assert int(ids[0, 0]) == 0 and float(d[0, 0]) < 1e-4
        live = _live_ids(self.fresh.storage)
        want = (initial | self.inserted) - self.deleted
        assert live == want, (f"missing={sorted(want - live)[:8]} "
                              f"extra={sorted(live - want)[:8]}")
        for vid in list(self.deleted)[:10]:
            assert self.fresh.storage.postings_of(vid) == []


def _build(tmp_path, data, cap, name, save):
    cfg = Config.from_dict({
        "clustering_params": {"initial_k": 4, "desired_cluster_size": cap, "rng_seed": 42},
        "output_path": str(tmp_path / name),
    })
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=save)
    return cfg, index


@pytest.mark.parametrize("scenario", ["compactor_thread", "inline_compact"])
def test_concurrent_search_update_compact(tmp_path, scenario):
    if scenario == "compactor_thread":
        data = 2.0 * np.random.default_rng(0).standard_normal((200, DIM)).astype(np.float32)
        cfg, _ = _build(tmp_path, data, 40, "cc", save=True)
        lire, prefetch = LireConfig(max_partition_size=80, min_partition_size=2), None
    else:
        rng = np.random.default_rng(0)
        data = rng.standard_normal((240, DIM)).astype(np.float32)
        cfg, _ = _build(tmp_path, data, 30, "idx", save=True)
        lire, prefetch = LireConfig(max_partition_size=60, min_partition_size=2), 2
    fresh = LazySpFreshIndex(cfg.output_path, lire_config=lire, prefetch_threads=prefetch,
                             device="cpu")
    s = Stress(fresh, data)
    initial = _live_ids(fresh.storage)
    nprobe = lambda: fresh.num_clusters  # noqa: E731 — read at each search
    try:
        if scenario == "compactor_thread":
            threads = [s.actor("searcher", s.searcher(data[[0, 5, 9]], 8, nprobe)),
                       s.actor("searcher", s.searcher(data[[0, 17, 42]], 8, nprobe)),
                       s.actor("mutator", s.random_mutator(20_000)),
                       s.actor("compactor", s.compactor())]
            s.run(threads, wall=8.0)
        else:
            rounds = [0]
            threads = [s.actor("searcher", s.searcher(data[:24], 5, nprobe, batch_size=8))
                       for _ in range(8)]
            threads.append(s.actor("writer", s.hot_spot_writer(rng, rounds)))
            s.run(threads, wall=3.0, switch=1e-5)
            assert rounds[0] >= 4
        s.assert_final(initial, nprobe)
    finally:
        fresh.close()


def test_concurrent_search_update_ram_tier(tmp_path):
    """The same stress on the in-RAM SpFreshIndex (search mirror +
    storage): a searcher against a mutator under continuous background
    splits."""
    data = 2.0 * np.random.default_rng(0).standard_normal((200, DIM)).astype(np.float32)
    _, index = _build(tmp_path, data, 40, "ram_idx", save=False)
    fresh = SpFreshIndex(index, str(tmp_path / "ram_lire"),
                         LireConfig(max_partition_size=80, min_partition_size=2))
    s = Stress(fresh, data)
    initial = _live_ids(fresh.storage)
    nprobe = lambda: index.num_clusters  # noqa: E731 — read at each search
    try:
        s.run([s.actor("searcher", s.searcher(data[[0, 5]], 8, nprobe)),
               s.actor("mutator", s.random_mutator(30_000))], wall=6.0)
        s.assert_final(initial, nprobe)
    finally:
        fresh.close()
