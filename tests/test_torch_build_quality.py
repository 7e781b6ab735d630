"""Build quality on the bench corpus, the port against the JAX package.

The bench corpus (``chip_smoke.mixture``) draws each point from one of
``max(64, n // 1000)`` Gaussian blobs, and the true 10 nearest neighbours
of a query lie in the query's own blob.  ``build_quality`` measures a
clustering with numpy and torch alone, the same way for either package:

- the share of posting members whose posting's centroid (a medoid, so a
  corpus point with a blob of its own) lies in the member's blob;
- the share of points, and of ground-truth neighbours, with no copy in
  such a posting;
- probe recall@10 at nprobe p: the share of ground-truth neighbours held
  by the p postings whose centroids lie nearest the query, which is the
  recall of a search that reranks its candidates exactly.

The tests hold the port, given the JAX package's initial seeds, to the
JAX build at a small n through both of the port's level paths.  Run as a
script, the file measures full-size builds of either package:

    JAX_PLATFORMS=cpu python tests/test_torch_build_quality.py --n 1000000
    python tests/test_torch_build_quality.py --n 4194304 --device cuda \\
        --packages port,port-seeded --seeds 11,22,...  # the JAX run's 16 seeds

``port`` builds with the port's own KMeans++ seeds, ``port-seeded`` with
``--seeds``: by default the JAX package's (computed, so it needs jax).
"""

import argparse
import hashlib
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from spfresh_tpu_torch.clustering import hierarchical as th  # noqa: E402
from spfresh_tpu_torch.index import brute_force_search  # noqa: E402
from spfresh_tpu_torch.index.config import Config as TConfig  # noqa: E402

NPROBES = (8, 16, 64, 256)


def bench_config(storage: str = "int8") -> dict:
    """The large phase's build configuration."""
    return {
        "clustering_params": {"distance_metric": "Euclidean", "initialization_method": "KMeans++",
                              "initial_k": 16, "desired_cluster_size": 256, "rng_seed": 42},
        "storage_dtype": storage,
    }


def build_quality(clusters, labels, host, queries, gt, nprobes=NPROBES) -> dict:
    """Placement and probe recall of ``clusters`` (objects with
    ``centroid_idx`` and ``points``) over the corpus ``host`` whose points
    lie in blobs ``labels``; ``gt`` (Q, k) are the queries' true ids."""
    n = len(labels)
    cid = np.array([c.centroid_idx for c in clusters], np.int64)
    members = [np.asarray(c.points, np.int64) for c in clusters]
    lens = np.array([len(m) for m in members])
    pts = np.concatenate(members)
    cls = np.repeat(np.arange(len(clusters)), lens)
    own = labels[pts] == labels[cid][cls]
    placed = np.zeros(n, bool)
    placed[pts[own]] = True
    # holders[p, r]: the r-th posting holding point p (-1 past its copies).
    order = np.argsort(pts, kind="stable")
    p_sorted, c_sorted = pts[order], cls[order]
    first = np.searchsorted(p_sorted, np.arange(n))
    copies = np.bincount(p_sorted, minlength=n)
    holders = np.full((n, int(copies.max())), -1, np.int64)
    holders[p_sorted, np.arange(len(p_sorted)) - first[p_sorted]] = c_sorted
    dq = torch.cdist(torch.from_numpy(queries).double(), torch.from_numpy(host[cid]).double())
    nearest = torch.topk(dq, min(max(nprobes), len(cid)), dim=1, largest=False).indices.numpy()
    held = holders[gt]  # (Q, k, copies)
    probe = {}
    for p in nprobes:
        hit = (held[..., None] == nearest[:, None, None, :p]).any(-1) & (held >= 0)
        probe[p] = float(hit.any(-1).mean())
    digest = hashlib.sha1(cid.tobytes() + b"".join(m.tobytes() for m in members)).hexdigest()
    return {"clusters": len(clusters), "stored": len(pts) / n, "own_blob_members": float(own.mean()),
            "points_without_own_blob_copy": float(1 - placed.mean()),
            "gt_without_own_blob_copy": float(1 - placed[gt].mean()), "probe_recall": probe,
            "digest": digest[:16]}


def jax_seeds(raw: dict, data: np.ndarray) -> np.ndarray:
    """The JAX package's initial seeds for ``raw`` on ``data``."""
    from spfresh_tpu.clustering import hierarchical as jh
    from spfresh_tpu.index.config import Config as JConfig

    params = JConfig.from_dict(raw).to_clustering_params()
    hc = jh.HierarchicalClustering(params, data)
    hc._initialize_clusters(params.initial_k)
    return np.array([c.centroid_idx for c in hc.clusters], np.int64)


def jax_fit(raw: dict, data: np.ndarray):
    from spfresh_tpu.clustering import hierarchical as jh
    from spfresh_tpu.index.config import Config as JConfig

    return jh.HierarchicalClustering(JConfig.from_dict(raw).to_clustering_params(), data).fit()


def port_fit(raw: dict, data: np.ndarray, seeds=None, device="cpu"):
    """The port's clustering; ``seeds`` replaces its own KMeans++ draw."""
    params = TConfig.from_dict(raw).to_clustering_params()
    real = th._kmeanspp_init
    if seeds is not None:
        th._kmeanspp_init = lambda X, k, metric, rng: seeds
    try:
        return th.HierarchicalClustering(params, data, device=device).fit()
    finally:
        th._kmeanspp_init = real


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

N_SMALL = 30_000


@pytest.fixture(scope="module")
def small():
    torch.set_num_threads(2)
    data, queries = chip_smoke.mixture(12345, N_SMALL, 200)
    labels = chip_smoke.mixture_blobs(12345, N_SMALL)
    _, gt = brute_force_search(data, queries, 10, device="cpu")
    raw = bench_config()
    ref = jax_fit(raw, data)
    want = build_quality(ref.clusters, labels, ref._host_data, queries, gt)
    return data, queries, labels, gt, raw, jax_seeds(raw, data), ref.clusters, want


def _key(c):
    return c.centroid_idx, np.asarray(c.points, np.int64).tobytes()


@pytest.mark.parametrize("levels", ["host", "device"])
def test_port_build_quality_equals_jax(small, monkeypatch, levels):
    """Given the JAX seeds, the port builds the JAX clusters at d = 128 on
    the bench corpus, and so its quality.  "device" sends every subdivision
    level through the torch level split that a CUDA build runs for its big
    levels.  Equal up to f32 near-ties: at this size one replica ranking
    differs, where two SOAR ranks lie 2.4e-5 apart (1.6e-7 relative, in
    f64) and the two packages' f32 sums order them differently."""
    data, queries, labels, gt, raw, seeds, ref_clusters, want = small
    if levels == "device":
        monkeypatch.setattr(th, "_tail_rows_for", lambda platform, d: 0)
    hc = port_fit(raw, data, seeds)
    got = build_quality(hc.clusters, labels, hc._host_data, queries, gt)
    same = len({_key(c) for c in ref_clusters} & {_key(c) for c in hc.clusters})
    assert same >= 0.99 * len(ref_clusters)
    assert got["clusters"] == want["clusters"]
    assert got["stored"] == pytest.approx(want["stored"], rel=1e-3)
    for key in ("own_blob_members", "points_without_own_blob_copy", "gt_without_own_blob_copy"):
        assert got[key] == pytest.approx(want[key], abs=1e-3), key
    for p, r in want["probe_recall"].items():
        assert got["probe_recall"][p] == pytest.approx(r, abs=5e-3), p
    assert want["clusters"] > 100 and want["stored"] > 2.0
    assert want["probe_recall"][64] > 0.99


def test_build_quality_counts():
    """The measure on a hand-made clustering of 6 points in two blobs."""
    Cl = type("Cl", (), {})

    def cl(c, p):
        o = Cl()
        o.centroid_idx, o.points = c, np.array(p)
        return o

    labels = np.array([0, 0, 0, 1, 1, 1])
    host = np.array([[0.0], [1.0], [2.0], [10.0], [11.0], [12.0]], np.float32)
    # Point 2 sits only in blob 1's posting; point 4 has copies in both.
    clusters = [cl(0, [0, 1, 4]), cl(3, [2, 3, 4, 5])]
    queries = np.array([[0.5], [11.5]], np.float32)
    gt = np.array([[0, 2], [4, 5]])
    q = build_quality(clusters, labels, host, queries, gt, nprobes=(1, 2))
    assert q["clusters"] == 2
    assert q["stored"] == pytest.approx(7 / 6)
    assert q["own_blob_members"] == pytest.approx(5 / 7)
    assert q["points_without_own_blob_copy"] == pytest.approx(1 / 6)
    assert q["gt_without_own_blob_copy"] == pytest.approx(1 / 4)
    # Query 0 probes posting 0 first (centroid 0.0): it misses point 2.
    assert q["probe_recall"] == {1: 3 / 4, 2: 1.0}


# ---------------------------------------------------------------------------
# Full-size witness
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--storage", default="int8")
    ap.add_argument("--packages", default="jax,port-seeded",
                    help="any of jax, port (its own seeds), port-seeded (--seeds)")
    ap.add_argument("--device", default="cpu", help="the port's build device")
    ap.add_argument("--seeds", default="jax", help="jax, or 16 comma-separated row ids")
    args = ap.parse_args()
    raw = bench_config(args.storage)
    t = time.perf_counter()
    data, queries = chip_smoke.mixture(12345, args.n, args.nq)
    labels = chip_smoke.mixture_blobs(12345, args.n)
    _, gt = brute_force_search(data, queries, 10, device=args.device, batch_size=1000)
    one_blob = float((labels[gt] == labels[gt[:, :1]]).all(1).mean())
    print(f"witness: n={args.n} nq={args.nq} storage={args.storage}; corpus and exact ground "
          f"truth in {time.perf_counter() - t:.1f} s; queries whose 10 true neighbours share "
          f"one blob {one_blob:.4f}", flush=True)
    packages = args.packages.split(",")
    if "port-seeded" in packages:
        if args.seeds == "jax":
            seeds = jax_seeds(raw, data)
            print(f"witness: jax seeds {','.join(map(str, seeds))}", flush=True)
        else:
            seeds = np.array([int(s) for s in args.seeds.split(",")], np.int64)
    for package in packages:
        t = time.perf_counter()
        if package == "jax":
            hc = jax_fit(raw, data)
        else:
            hc = port_fit(raw, data, seeds if package == "port-seeded" else None, args.device)
            package += f" {args.device}"
        fit_s = time.perf_counter() - t
        q = build_quality(hc.clusters, labels, hc._host_data, queries, gt)
        print(f"witness: {package}: fit {fit_s:.1f} s clusters={q['clusters']} "
              f"stored=x{q['stored']:.4f} digest={q['digest']} "
              f"own-blob members {q['own_blob_members']:.4f}; points with no own-blob copy "
              f"{q['points_without_own_blob_copy']:.4f}; ground-truth neighbours with none "
              f"{q['gt_without_own_blob_copy']:.4f}; probe recall@10 " + " ".join(
                  f"nprobe={p}:{r:.4f}" for p, r in q["probe_recall"].items()), flush=True)
        del hc
    return 0


if __name__ == "__main__":
    sys.exit(main())
