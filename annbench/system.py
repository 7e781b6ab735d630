"""The system under test: ``spfresh_tpu_torch``'s SPANN index, kept live by
its ``SpFreshIndex`` where the configuration has a ``lire`` section.

This is the one module of the benchmark that imports the program.  The
harness reaches the program only through ``ProgramSystem``'s methods, so a
control or a planted fault can stand in its place with the same methods.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile

import numpy as np
import torch


@dataclasses.dataclass
class Snapshot:
    """What the searches saw: each posting's centroid (C, d) f32 and its
    members, as (member id, posting index into ``centroids``) pairs.  None
    in place of a snapshot means every live row is reachable (an exact
    search probes everything)."""

    centroids: np.ndarray
    member_ids: np.ndarray
    member_post: np.ndarray


class ProgramSystem:
    def __init__(self, config: dict, device):
        self.config, self.device = config, torch.device(device)
        self.index = None
        self.fresh = None
        self.store = None

    def build(self, corpus: np.ndarray) -> None:
        """Build the index from the corpus and pack its device view."""
        from spfresh_tpu_torch.index import Config, SpannIndexBuilder

        cfg = Config.from_dict(dict(self.config["index"]))
        self.index = SpannIndexBuilder(cfg, device=self.device).with_data(corpus).build(
            save=False)
        self.index.padded_view()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def open_live(self) -> None:
        """Keep the index live (SpFreshIndex) with its store under TMPDIR."""
        from spfresh_tpu_torch.lire import LireConfig, SpFreshIndex

        self.store = tempfile.mkdtemp(prefix="annbench-lire-")
        self.fresh = SpFreshIndex(self.index, self.store, LireConfig(**self.config["lire"]))

    @property
    def num_stored(self) -> int:
        return self.index.num_vectors

    def search(self, queries: np.ndarray, k: int, nprobe: int):
        target = self.fresh if self.fresh is not None else self.index
        return target.search(queries, k, nprobe=nprobe)

    def insert(self, vectors: np.ndarray, ids: np.ndarray) -> int:
        self.fresh.insert_batch(vectors, ids)
        return len(ids)

    def delete(self, ids: np.ndarray) -> int:
        return self.fresh.delete_batch(ids)

    def quiesce(self) -> None:
        """Let queued background work finish and stop the worker."""
        if self.fresh is not None and self.fresh.pipeline.is_running:
            self.fresh.pipeline.stop()

    def snapshot(self) -> Snapshot:
        idx = self.index
        cids = sorted(idx.postings)
        lens = np.array([len(idx.postings[c][0]) for c in cids], np.int64)
        ids = (np.concatenate([np.asarray(idx.postings[c][0], np.int64) for c in cids])
               if cids else np.zeros(0, np.int64))
        cent = (np.stack([np.asarray(idx.centroids[c], np.float32) for c in cids])
                if cids else np.zeros((0, idx.dim), np.float32))
        return Snapshot(cent, ids, np.repeat(np.arange(len(cids)), lens))

    def search_and_snapshot(self, queries: np.ndarray, k: int, nprobe: int):
        """A search and the postings it saw, under the live index's lock."""
        if self.fresh is None:
            return self.search(queries, k, nprobe), self.snapshot()
        with self.fresh._lock:
            return self.fresh.search(queries, k, nprobe=nprobe), self.snapshot()

    @staticmethod
    def counters() -> dict:
        from spfresh_tpu_torch.utils import metrics

        return metrics.snapshot()

    def close(self) -> None:
        """Stop background work and release the index and its store."""
        self.quiesce()
        self.fresh = None
        self.index = None
        if self.store is not None:
            shutil.rmtree(self.store, ignore_errors=True)
            self.store = None
