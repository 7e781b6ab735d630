"""Twin of tests/test_spfresh_model_fuzz.py for the port's in-RAM SpFresh
stack (``SpFreshIndex``: ``LireStorage``, the in-RAM ``SpannIndex``
search mirror, the protocol and the background pipeline) on the CPU.

One random insert / insert_batch / delete / delete_batch sequence (the
JAX test's seeds, corpus and ``SPF_FUZZ_STEPS`` steps, default 150) runs
in lockstep through the JAX package's ``SpFreshIndex`` and the port's,
each over its own package's build of the same corpus, while a dict
``vid -> vector`` tracks the expected live set.  After every
``flush()`` the port's storage live set, its search mirror
(``index.postings``) and the model are equal, with the stored vectors
exactly the inserted ones; no deleted vid comes back; and a full-probe
self-query finds each probed vid at distance < 1e-4.  The JAX run is
held to its own test's checks at the same points and gives the same live
set."""

import os

import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.lire import LireConfig as JLireConfig
from spfresh_tpu.lire.fresh import SpFreshIndex as JSpFreshIndex
from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.lire import LireConfig
from spfresh_tpu_torch.lire.fresh import SpFreshIndex
from test_spfresh_model_fuzz import _check as _jax_check
from test_spfresh_model_fuzz import _mirror_live, _storage_live

torch.set_num_threads(2)

_STEPS = int(os.environ.get("SPF_FUZZ_STEPS", "150"))  # deeper local grinds; CI default 150

DIM = 8


def _check(fresh, model, deleted, ctx):
    fresh.flush()
    for name, live in (("storage", _storage_live(fresh.storage)),
                       ("mirror", _mirror_live(fresh.index))):
        assert set(live) == set(model), (
            f"{ctx} [{name}]: missing={set(model) - set(live)} extra={set(live) - set(model)}")
        assert not (set(live) & deleted), f"{ctx} [{name}]: resurrected"
        for vid, vec in model.items():
            np.testing.assert_array_equal(live[vid], vec, err_msg=f"{ctx} [{name}] vid {vid}")
    probe = list(model.items())[:4]
    if probe:
        q = np.stack([v for _, v in probe])
        ids, d = fresh.search(q, 1, nprobe=fresh.index.num_clusters)
        for r, (vid, _) in enumerate(probe):
            assert int(ids[r, 0]) == vid, f"{ctx}: self-query missed"
            assert float(d[r, 0]) < 1e-4, ctx


def _config(mod, tmp_path, seed):
    return mod.from_dict({
        "clustering_params": {"initial_k": 4, "desired_cluster_size": 30, "rng_seed": 42,
                              "max_replicas": 2},
        "output_path": str(tmp_path / f"sf{seed}"),
    })


@pytest.mark.parametrize("seed", [0, 1])
def test_spfresh_model_fuzz(tmp_path, seed):
    rng = np.random.default_rng(4000 + seed)
    data = 2.0 * rng.standard_normal((150, DIM)).astype(np.float32)
    lire = dict(max_partition_size=60, min_partition_size=2)
    jidx = JBuilder(_config(JConfig, tmp_path, seed)).with_data(data).build(save=False)
    pidx = SpannIndexBuilder(_config(Config, tmp_path, seed), device="cpu").with_data(
        data).build(save=False)
    jf = JSpFreshIndex(jidx, str(tmp_path / "jlire"), JLireConfig(**lire))
    pf = SpFreshIndex(pidx, str(tmp_path / "lire"), LireConfig(**lire))
    model = _storage_live(pf.storage)
    assert set(model) == set(_storage_live(jf.storage)) == set(range(len(data)))
    deleted: set = set()
    next_vid = 10_000

    def check(ctx):
        _check(pf, model, deleted, ctx)
        _jax_check(jf, model, deleted, f"{ctx} (jax)")
        assert set(_storage_live(jf.storage)) == set(_storage_live(pf.storage)), ctx

    try:
        for step in range(_STEPS):
            op = rng.choice(["insert", "insert_batch", "delete", "delete_batch"],
                            p=[0.4, 0.2, 0.27, 0.13])
            if op == "insert":
                v = 2.0 * rng.standard_normal(DIM).astype(np.float32)
                jf.insert(v, next_vid)
                pf.insert(v, next_vid)
                model[next_vid] = v
                next_vid += 1
            elif op == "insert_batch":
                kk = int(rng.integers(2, 12))
                vs = 2.0 * rng.standard_normal((kk, DIM)).astype(np.float32)
                vids = list(range(next_vid, next_vid + kk))
                jf.insert_batch(vs, vids)
                pf.insert_batch(vs, vids)
                for vid, v in zip(vids, vs):
                    model[vid] = v
                next_vid += kk
            elif op == "delete" and model:
                vid = int(rng.choice(sorted(model)))
                jf.delete(vid)
                pf.delete(vid)
                model.pop(vid)
                deleted.add(vid)
            elif op == "delete_batch" and model:
                vids = [int(v) for v in rng.permutation(sorted(model))[:4]]
                jf.delete_batch(vids)
                pf.delete_batch(vids)
                for vid in vids:
                    model.pop(vid)
                    deleted.add(vid)
            if step % 15 == 14:
                check(f"seed {seed} step {step}")
        check(f"seed {seed} final")
    finally:
        jf.close()
        pf.close()
