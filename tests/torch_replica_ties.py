"""Shared by the port's build twins: proof in f64 that a replica
membership in which the port's clusters and the JAX package's differ is a
tie of the f32 closure replica pass (ROADMAP Queue 3)."""

import numpy as np

# The f32 expansion |x|^2 + |c|^2 - 2 x.c rounds within a few ulps of its
# terms, so a gap under this fraction of |x|^2 + |c|^2 is an f32 tie.
EXPANSION_TIE_RTOL = 1e-6


def replica_diff_is_tie(data, pre, ref, port, bt):
    """Every (point, cluster) membership in one package's clusters and not
    the other's is a replica at an f64 near-tie, relative to the
    expansion's terms: at the admission bound D < bt * db (db ~ 0 on a
    duplicate of its base centroid), at the closure bound CC >= D, or at
    the replica cut, against a centroid admitted in f64 with an equal rank
    that the same package left out of the point's clusters (the other
    package kept it, or the cluster's budget dropped it).  Returns the
    count."""
    X = data.astype(np.float64)
    C = X[[c.centroid_idx for c in ref.clusters]]
    base = np.zeros(len(X), np.int64)
    for ci, pts in enumerate(pre):
        base[pts] = ci
    clusters = {name: [set(c.points.tolist()) for c in hc.clusters]
                for name, hc in (("ref", ref), ("port", port))}
    only = {}  # point -> {"ref": clusters, "port": clusters}
    for j, (a, b) in enumerate(zip(ref.clusters, port.clusters)):
        sa, sb = set(a.points.tolist()), set(b.points.tolist())
        for p in sa - sb:
            only.setdefault(p, {"ref": [], "port": []})["ref"].append(j)
        for p in sb - sa:
            only.setdefault(p, {"ref": [], "port": []})["port"].append(j)
    for p, sides in only.items():
        b = base[p]
        D = ((X[p] - C) ** 2).sum(1)
        CC = ((C[b] - C) ** 2).sum(1)
        scale = X[p] @ X[p] + (C * C).sum(1) + C[b] @ C[b]
        tie = EXPANSION_TIE_RTOL * scale
        for mine in ("ref", "port"):
            for j in sides[mine]:
                assert j != b, f"point {p}: base cluster {b} differs"
                at_bound = abs(D[j] - bt * D[b]) <= tie[j] or abs(CC[j] - D[j]) <= tie[j]
                held = {ci for ci, c in enumerate(clusters[mine]) if p in c}
                rivals = np.flatnonzero((D < bt * D[b]) & (CC >= D))  # admitted in f64
                at_cut = any(abs(D[j] - D[i]) <= max(tie[j], tie[i])
                             for i in rivals if i != b and i not in held)
                assert at_bound or at_cut, (
                    f"point {p}: replica in cluster {j} only in {mine} without an f64 tie "
                    f"(D {D[j]}, db {D[b]}, CC {CC[j]})")
    return sum(len(v["ref"]) + len(v["port"]) for v in only.values())
