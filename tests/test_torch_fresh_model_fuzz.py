"""Twin of tests/test_fresh_model_fuzz.py for the port's disk-tier live
updates (``LazySpFreshIndex`` over ``PackedLireStorage``: protocol,
two-stage pipeline, background Split/Merge/Reassign, packed base, RAM
overlay, WAL, lazy search) on the CPU.

One random insert / insert_batch / delete / delete_batch / compact /
reopen sequence (the JAX test's seeds, corpus, storage dtypes and
``SPF_FUZZ_STEPS`` steps, default 150) runs in lockstep through the JAX
package's ``LazySpFreshIndex`` and the port's, each over its own
package's packed build of the same corpus, while a dict ``vid -> vector``
tracks the expected live set.  After every ``flush()`` the port's live
set equals the model's, the stored vectors are the inserted f32 ones
under every storage dtype, no deleted vid comes back (across compact and
reopen too), and a full-probe self-query finds each probed vid (at
distance < 1e-4 for float slabs); the JAX run passes its own test's
checks at the same points.  After the final flush and ``compact()``
each package's directory opens in the other's ``PackedLireStorage``
with the same live set (the save/load invariant), before and after a
compaction."""

import os

import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.lire import LireConfig as JLireConfig
from spfresh_tpu.lire.lazy_fresh import LazySpFreshIndex as JLazyFresh
from spfresh_tpu.lire.packed_storage import PackedLireStorage as JPacked
from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.lire import LireConfig
from spfresh_tpu_torch.lire.lazy_fresh import LazySpFreshIndex
from spfresh_tpu_torch.lire.packed_storage import PackedLireStorage
from test_fresh_model_fuzz import _check as _jax_check
from test_fresh_model_fuzz import _live_map

torch.set_num_threads(2)

_STEPS = int(os.environ.get("SPF_FUZZ_STEPS", "150"))  # deeper local grinds; CI default 150

DIM = 8
LIRE = dict(max_partition_size=60, min_partition_size=2)


def _check(fresh, model, deleted, ctx, exact_dist):
    fresh.flush()
    live = _live_map(fresh.storage)
    assert set(live) == set(model), (
        f"{ctx}: live set mismatch (missing={set(model) - set(live)}, "
        f"extra={set(live) - set(model)})")
    for vid, vec in model.items():
        # Disk stays exact f32 under every storage dtype.
        np.testing.assert_array_equal(live[vid], vec, err_msg=f"{ctx} vid {vid}")
    assert not (set(live) & deleted), f"{ctx}: deleted vid resurrected"
    # int8 slabs carry quantized residuals: top-1 identity holds, the
    # self-distance is ~0 only for exact slabs.
    probe = list(model.items())[:4]
    if probe:
        q = np.stack([v for _, v in probe])
        ids, d = fresh.search(q, 1, nprobe=fresh.num_clusters)
        for r, (vid, _) in enumerate(probe):
            assert int(ids[r, 0]) == vid, f"{ctx}: self-query missed"
            if exact_dist:
                assert float(d[r, 0]) < 1e-4, ctx


def _build(mod_config, builder, tmp_path, seed, sd, data, tag, **kw):
    cfg = mod_config.from_dict({
        "storage_dtype": sd,
        "clustering_params": {"initial_k": 4, "desired_cluster_size": 30, "rng_seed": 42,
                              "max_replicas": 2},
        "output_path": str(tmp_path / f"{tag}{seed}"),
    })
    builder(cfg, **kw).with_data(data).build(save=True)
    return cfg.output_path


def _assert_crossed(jdir, pdir, model, ctx):
    """Each package's directory opens in the other's PackedLireStorage
    with the model's live set and vectors."""
    for opener, path in ((JPacked, pdir), (PackedLireStorage, jdir)):
        st = opener(path)
        live = _live_map(st)
        assert set(live) == set(model), f"{ctx}: {opener.__module__} on {path}"
        for vid, vec in model.items():
            np.testing.assert_array_equal(live[vid], vec, err_msg=ctx)
        st.close()


@pytest.mark.parametrize("sd", ["float32", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lazy_fresh_model_fuzz(tmp_path, seed, sd):
    rng = np.random.default_rng(3000 + seed)
    data = 2.0 * rng.standard_normal((150, DIM)).astype(np.float32)
    jdir = _build(JConfig, JBuilder, tmp_path, seed, sd, data, "jfz")
    pdir = _build(Config, SpannIndexBuilder, tmp_path, seed, sd, data, "fz", device="cpu")

    def open_both():
        return (JLazyFresh(jdir, lire_config=JLireConfig(**LIRE)),
                LazySpFreshIndex(pdir, lire_config=LireConfig(**LIRE), device="cpu"))

    jf, pf = open_both()
    model = _live_map(pf.storage)
    assert set(model) == set(_live_map(jf.storage)) == set(range(len(data)))
    deleted: set = set()
    next_vid = 10_000
    exact = sd != "int8"

    def check(ctx):
        _check(pf, model, deleted, ctx, exact)
        _jax_check(jf, model, deleted, f"{ctx} (jax)", exact_dist=exact)

    try:
        # Default 150 steps: the depth that caught the same-posting duplicate (r4).
        for step in range(_STEPS):
            op = rng.choice(["insert", "insert_batch", "delete", "delete_batch", "compact",
                             "reopen"], p=[0.35, 0.2, 0.2, 0.1, 0.08, 0.07])
            if op == "insert":
                v = 2.0 * rng.standard_normal(DIM).astype(np.float32)
                for f in (jf, pf):
                    f.insert(v, next_vid)
                model[next_vid] = v
                next_vid += 1
            elif op == "insert_batch":
                kk = int(rng.integers(2, 12))
                vs = 2.0 * rng.standard_normal((kk, DIM)).astype(np.float32)
                vids = list(range(next_vid, next_vid + kk))
                for f in (jf, pf):
                    f.insert_batch(vs, vids)
                for vid, v in zip(vids, vs):
                    model[vid] = v
                next_vid += kk
            elif op == "delete" and model:
                vid = int(rng.choice(sorted(model)))
                for f in (jf, pf):
                    f.delete(vid)
                model.pop(vid)
                deleted.add(vid)
            elif op == "delete_batch" and model:
                vids = [int(v) for v in rng.permutation(sorted(model))[:4]]
                for f in (jf, pf):
                    f.delete_batch(vids)
                for vid in vids:
                    model.pop(vid)
                    deleted.add(vid)
            elif op == "compact":
                for f in (jf, pf):
                    f.compact()
            elif op == "reopen":
                for f in (jf, pf):
                    f.flush()
                    f.close()
                jf, pf = open_both()
            if step % 12 == 11:
                check(f"seed {seed} step {step}")
        check(f"seed {seed} final")
        for f in (jf, pf):
            f.close()
        _assert_crossed(jdir, pdir, model, f"seed {seed} final, WAL replayed")
        jf, pf = open_both()  # durability: everything survives one more reopen
        check(f"seed {seed} post-final-reopen")
        for f in (jf, pf):
            f.compact()
        check(f"seed {seed} post-final-compact")
        for f in (jf, pf):
            f.close()
        _assert_crossed(jdir, pdir, model, f"seed {seed} compacted")
    finally:
        jf.close()
        pf.close()
