"""The slab-major schedule of the rerank kernel (``ops/rerank.py::
rerank_schedule``): the CPU form of the counting sort in ``csrc/rerank.cu``.

``walk`` reads the schedule as the kernel does (item b < totals[0] is
``{slab, first, count}``: the pairs order[first:first + count]; the pairs
from totals[1] on are the out-of-range ones, whose rows are NaN),
so the tests hold what the kernel computes: every pair once, one slab per
item, NaN rows for out-of-range slab indices."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spfresh_tpu_torch.ops import rerank as tr

torch.set_num_threads(2)


def walk(rows, cpad, group):
    """(items as (slab, pairs), out-of-range pairs, n_slots), read as the
    kernel reads them."""
    order, items, totals = (t.numpy() for t in tr.rerank_schedule(
        torch.from_numpy(rows), cpad, group))
    n_items, n_valid, counter = (int(c) for c in totals)
    assert counter == 0  # the kernel's item counter starts at 0
    P = rows.size
    assert order.dtype == items.dtype == totals.dtype == np.int32
    assert order.shape == (P,) and items.shape[1] == 4
    assert n_items <= items.shape[0]
    flat = rows.reshape(-1)
    walked = []
    for slab, first, count, _ in items[:n_items].tolist():
        pairs = order[first : first + count].tolist()
        assert first + count <= n_valid and all(flat[p] == slab for p in pairs)
        walked.append((slab, pairs))
    return walked, order[n_valid:].tolist(), items.shape[0]


def rerank_by_schedule(q, rows, v, group):
    """The kernel's output as the walk fills it, from the plain distances of
    each item's pairs; NaN for the out-of-range pairs; -1 where nothing was
    written."""
    Q, nprobe = rows.shape
    cpad, pad, _ = v.shape
    out = np.full((Q * nprobe, pad), -1.0, np.float32)
    walked, out_of_range, _ = walk(rows, cpad, group)
    for slab, pairs in walked:
        for p in pairs:
            qq = torch.from_numpy(q[p // nprobe][None])
            r = torch.tensor([[slab]], dtype=torch.int32)
            out[p] = tr.padded_rerank_distances_plain(qq, r, torch.from_numpy(v))[0, 0].numpy()
    out[out_of_range] = np.nan
    return out.reshape(Q, nprobe, pad)


def check_walk(rows, cpad, group):
    walked, out_of_range, n_slots = walk(rows, cpad, group)
    flat = rows.reshape(-1)
    valid = (flat >= 0) & (flat < cpad)
    seen = [p for _, pairs in walked for p in pairs]
    # Every in-range pair exactly once, in the item of its own slab.
    assert sorted(seen) == np.flatnonzero(valid).tolist()
    for slab, pairs in walked:
        assert 1 <= len(pairs) <= group
        assert all(flat[p] == slab for p in pairs)
        assert pairs == sorted(pairs)  # stable: a slab's pairs in pair order
    # Items in slab order; a slab's run is cut into ceil(count / group) items.
    slabs = [s for s, _ in walked]
    assert slabs == sorted(slabs)
    for s, c in zip(*np.unique(flat[valid], return_counts=True)):
        assert slabs.count(s) == -(-int(c) // group)
    # Out-of-range pairs form no item; the kernel writes their NaN rows.
    assert sorted(out_of_range) == np.flatnonzero(~valid).tolist()
    assert n_slots == min(flat.size, -(-flat.size // group) + min(flat.size, cpad))
    return walked


def test_every_pair_once_one_slab_per_item():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 40, (64, 8)).astype(np.int32)
    walked = check_walk(rows, 40, 16)
    assert max(len(p) for _, p in walked) == 16  # 512 pairs over 40 slabs: full items


def test_hot_slab_becomes_many_items():
    rows = np.full((100, 3), 7, np.int32)
    walked = check_walk(rows, 9, 16)
    assert [len(p) for _, p in walked] == [16] * 18 + [12]
    assert {s for s, _ in walked} == {7}


def test_single_pair():
    walked = check_walk(np.array([[5]], np.int32), 6, 16)
    assert walked == [(5, [0])]


def test_out_of_range_rows_excluded_and_nan():
    rng = np.random.default_rng(1)
    Q, nprobe, cpad, pad, d = 5, 4, 6, 7, 16
    rows = rng.integers(0, cpad, (Q, nprobe)).astype(np.int32)
    rows[0, 1], rows[2, 3], rows[4, 0] = -1, cpad, 2**31 - 1
    check_walk(rows, cpad, 3)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    v = rng.standard_normal((cpad, pad, d)).astype(np.float32)
    got = rerank_by_schedule(q, rows, v, 3)
    bad = (rows < 0) | (rows >= cpad)
    assert np.isnan(got[bad]).all()
    assert not np.isnan(got[~bad]).any() and (got[~bad] >= 0).all()  # every row written
    want = tr.padded_rerank_distances_plain(
        torch.from_numpy(q), torch.from_numpy(np.where(bad, 0, rows).astype(np.int32)),
        torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got[~bad], want[~bad])


def test_all_rows_out_of_range():
    walked, out_of_range, _ = walk(np.array([[9, -3], [12, 10]], np.int32), 9, 16)
    assert walked == [] and sorted(out_of_range) == [0, 1, 2, 3]


@settings(max_examples=60, deadline=None)
@given(
    Q=st.integers(1, 40),
    nprobe=st.integers(1, 12),
    cpad=st.integers(1, 30),
    group=st.sampled_from([1, 2, 3, 8, 16, 32]),
    hot=st.floats(0.0, 1.0),
    bad=st.floats(0.0, 0.3),
    seed=st.integers(0, 2**31 - 1),
)
def test_schedule_random_rows(Q, nprobe, cpad, group, hot, bad, seed):
    """Random rows with a hot slab taking a share ``hot`` of the pairs and a
    share ``bad`` out of range (both signs)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cpad, (Q, nprobe))
    rows = np.where(rng.random((Q, nprobe)) < hot, cpad // 2, rows)
    wrong = rng.choice([-5, -1, cpad, cpad + 7], (Q, nprobe))
    rows = np.where(rng.random((Q, nprobe)) < bad, wrong, rows).astype(np.int32)
    check_walk(rows, cpad, group)


@pytest.mark.parametrize("group", [1, 4, 16])
def test_walk_reproduces_the_plain_rerank(group):
    """Distances filled item by item equal the plain version's."""
    rng = np.random.default_rng(2)
    Q, nprobe, cpad, pad, d = 9, 5, 4, 6, 32
    rows = rng.integers(0, cpad, (Q, nprobe)).astype(np.int32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    v = rng.standard_normal((cpad, pad, d)).astype(np.float32)
    got = rerank_by_schedule(q, rows, v, group)
    want = tr.padded_rerank_distances_plain(torch.from_numpy(q), torch.from_numpy(rows),
                                            torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
