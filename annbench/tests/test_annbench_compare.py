"""``compare`` on fixed synthetic inputs: the float branches (f32 and bf16
storage) give the numbers the harness gave before it learnt int8 storage,
so the cells stored in those dtypes read as they did."""

import numpy as np
import pytest
import torch

from annbench.check import Answers, Ledger, compare
from annbench.system import Snapshot

K, NPROBE = 10, 4


def inputs(storage: torch.dtype):
    """A mixture of 800 rows in 16 dimensions, 24 postings (a row in its
    nearest and, where nearly as near, its second), and three judged
    requests of 10 queries answered by a plain search over the probed
    postings, with planted faults: distances 3e-4 off (request 0), a far id
    in place of the nearest (request 1), deleted ids (request 2), each of
    the last two at its own distance; rows 400-409 stray."""
    g = torch.Generator().manual_seed(1919)
    centers = 3.0 * torch.randn(8, 16, generator=g)
    rows = centers[torch.randint(0, 8, (800,), generator=g)] + 0.7 * torch.randn(
        800, 16, generator=g)
    table = centers[torch.randint(0, 8, (30,), generator=g)] + 0.7 * torch.randn(
        30, 16, generator=g)
    cent = rows[:24].clone()
    d = torch.cdist(rows.double(), cent.double()) ** 2
    near = torch.topk(d, 2, dim=1, largest=False)
    ids = [np.arange(800), np.flatnonzero((near.values[:, 1] < 1.1 * near.values[:, 0]).numpy())]
    posts = [near.indices[:, 0].numpy().copy(), near.indices[:, 1].numpy()[ids[1]]]
    posts[0][400:410] = (posts[0][400:410] + 7) % 24     # strays
    snap = Snapshot(cent.numpy(), np.concatenate(ids), np.concatenate(posts))
    stored = rows.to(storage).to(torch.float32)
    probe = torch.topk(torch.cdist(table.double(), cent.double()), NPROBE, dim=1,
                       largest=False).indices.numpy()
    dead = np.full(800, np.inf)
    dead[[5, 77, 301]] = 0.5
    out_ids = np.zeros((30, K), np.int64)
    out_d = np.zeros((30, K), np.float32)
    for q in range(30):
        cand = np.unique(snap.member_ids[np.isin(snap.member_post, probe[q])])
        cand = cand[~np.isfinite(dead[cand])] if q != 25 else cand
        dq = ((stored[cand] - table[q]) ** 2).sum(1).numpy()
        order = np.argsort(dq, kind="stable")[:K]
        out_ids[q], out_d[q] = cand[order], dq[order]
    out_d[:10] *= np.float32(1 + 3e-4)
    far = 799 if out_ids[12, 0] != 799 else 798
    out_ids[12, 0], out_d[12, 0] = far, ((stored[far] - table[12]) ** 2).sum()
    out_ids[25, 3], out_d[25, 3] = 77, ((stored[77] - table[25]) ** 2).sum()
    answers = [Answers(np.arange(s, s + 10), out_ids[s:s + 10], out_d[s:s + 10], 1.0, 2.0, True)
               for s in (0, 10, 20)]
    ledger = Ledger(np.full(800, -np.inf), dead)
    return rows, table, answers, ledger, snap


# What the harness's comparison gave on these inputs before its int8 branch.
PARENT = {
    torch.float32: {"dist_err": 0.0003001585890278254, "wrong": 4,
                    "missed": 0.007194244604316547, "stray": 0.010037641154328732,
                    "recall_at_10": 0.9766666666666667},
    torch.bfloat16: {"dist_err": 0.0003001515232343883, "wrong": 4,
                     "missed": 0.007168458781362007, "stray": 0.010037641154328732,
                     "recall_at_10": 0.9633333333333334},
}


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=str)
def test_float_branches_read_as_before(storage):
    rows, table, answers, ledger, snap = inputs(storage)
    got = compare(rows, table, answers, ledger, snap, k=K, nprobe=NPROBE, storage=storage)
    want = PARENT[storage]
    assert got["wrong"] == want["wrong"]
    for name in ("dist_err", "missed", "stray", "recall_at_10"):
        assert got[name] == pytest.approx(want[name], rel=1e-12, abs=0), name
