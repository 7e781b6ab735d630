"""The expansion-form int8 scorer (``padded_rerank_distances_int8mxu``) as
its CUDA kernel computes it: the pairs walked item by item through the
rerank's slab-major schedule (``rerank_schedule``, group 16), each item's
dots summed over k-chunks of its slab in int32 and combined in f32 in the
kernel's order.  The walk must be bit-equal to the plain version (what a
CPU tensor runs) and agree with the JAX package's ``int8mxu_rerank_oracle``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spfresh_tpu.ops.pallas import rerank as jr
from spfresh_tpu_torch.ops import rerank as tr

torch.set_num_threads(2)

GROUP = 16  # the rerank kernel's work-item size (kGroup in csrc/slab_ring.cuh)
# tests/test_pallas_rerank.py's tolerance for this scorer against the JAX
# oracle: the dots are exact, the final combine may differ by an ulp.
RTOL, ATOL = 3e-7, 1e-3


def sq8(seed, C, d, pad, Q, nprobe, rows=None):
    """Random int8 slab codes (every byte value), their |r|^2 table, slab
    scales and quantized centered queries, as numpy arrays."""
    rng = np.random.default_rng(seed)
    codesT = rng.integers(-128, 128, (C, d, pad)).astype(np.int8)
    norms2 = (codesT.astype(np.int64) ** 2).sum(axis=1).astype(np.int32)
    scales = (rng.random(C) * 0.02 + 0.005).astype(np.float32)
    cents = rng.standard_normal((C, d)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    if rows is None:
        rows = rng.integers(0, C, (Q, nprobe)).astype(np.int32)
    safe = np.clip(rows, 0, C - 1)
    qc, qs, qn = (a.numpy() for a in tr.quantize_centered_queries(
        torch.from_numpy(q), torch.from_numpy(cents), torch.from_numpy(safe)))
    return qc, qs, qn, rows, codesT, norms2, scales


def score_by_schedule(qcodes, qscale, qnorm2, rows, codesT, norms2, scales, kc):
    """The kernel's output as its blocks fill it: each work item's pairs
    against the item's slab, the int dots summed over k-chunks of ``kc``
    rows, then ``qn2 - (2 s_j s_q) dot + s_j^2 n2`` in f32, each operation
    rounded on its own; NaN rows for the out-of-range pairs; -1 where no
    item wrote."""
    Q, nprobe, d = qcodes.shape
    C, _, pad = codesT.shape
    out = np.full((Q * nprobe, pad), -1.0, np.float32)
    order, items, totals = (t.numpy() for t in tr.rerank_schedule(
        torch.from_numpy(rows), C, GROUP))
    n_items, n_valid, _ = (int(c) for c in totals)
    qflat = qcodes.reshape(-1, d).astype(np.int64)
    for slab, first, count, _ in items[:n_items].tolist():
        pairs = order[first : first + count]
        assert 1 <= count <= GROUP and (rows.reshape(-1)[pairs] == slab).all()
        codes = codesT[slab].astype(np.int64)  # (d, pad)
        dot = np.zeros((count, pad), np.int64)
        for k0 in range(0, d, kc):
            dot += qflat[pairs, k0 : k0 + kc] @ codes[k0 : k0 + kc]
        assert np.abs(dot).max(initial=0) < 2**24  # exact in f32
        sj = scales[slab]
        k2 = (np.float32(2.0) * sj) * qscale.reshape(-1)[pairs]
        t = qnorm2.reshape(-1)[pairs][:, None] - k2[:, None] * dot.astype(np.float32)
        out[pairs] = t + (sj * sj) * norms2[slab].astype(np.float32)
    out[order[n_valid:]] = np.nan
    return out.reshape(Q, nprobe, pad)


def plain(args):
    return tr.padded_rerank_distances_int8mxu_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).numpy()


def check_walk(args, kc):
    """The walk bit-equal to the plain version on the in-range pairs (the
    plain version reads out-of-range rows as slab 0), NaN rows elsewhere."""
    qc, qs, qn, rows, codesT, norms2, scales = args
    got = score_by_schedule(qc, qs, qn, rows, codesT, norms2, scales, kc)
    bad = (rows < 0) | (rows >= codesT.shape[0])
    want = plain((qc, qs, qn, np.where(bad, 0, rows).astype(np.int32), codesT, norms2, scales))
    assert np.isnan(got[bad]).all()
    assert not np.isnan(got[~bad]).any() and (got[~bad] != -1.0).all()  # every row written
    np.testing.assert_array_equal(got[~bad].view(np.uint32), want[~bad].view(np.uint32))
    return got


@pytest.mark.parametrize("d, pad, kc", [(16, 4, 4), (20, 240, 8), (128, 336, 20),
                                        (128, 240, 128), (960, 528, 12)])
def test_walk_bit_equal_to_plain(d, pad, kc):
    """Random rows (items of 1 to 16 pairs), k-chunks that do and do not
    divide d, and d 960 x pad 528: a slab deeper than shared memory."""
    args = sq8(0, C=6, d=d, pad=pad, Q=9 if d < 960 else 4, nprobe=7 if d < 960 else 5)
    check_walk(args, kc)


def test_hot_slab_many_items():
    rows = np.full((100, 5), 2, np.int32)
    rows[::7, 1] = 4
    args = sq8(1, C=5, d=64, pad=36, Q=100, nprobe=5, rows=rows)
    order, items, totals = tr.rerank_schedule(torch.from_numpy(rows), 5, GROUP)
    assert int(totals[0]) == 31 + 1  # 485 pairs on slab 2 (31 items), 15 on slab 4
    check_walk(args, 16)


def test_single_pair():
    args = sq8(2, C=3, d=128, pad=240, Q=1, nprobe=1, rows=np.array([[1]], np.int32))
    check_walk(args, 20)


def test_equal_rows_tie_in_the_plain_order():
    """Slabs whose pad rows are all equal: every score of a (query, probe)
    row ties, and the walk keeps the plain version's stable order."""
    qc, qs, qn, rows, codesT, norms2, scales = sq8(3, C=4, d=40, pad=12, Q=6, nprobe=3)
    codesT = np.ascontiguousarray(np.repeat(codesT[:, :, :1], 12, axis=2))
    norms2 = (codesT.astype(np.int64) ** 2).sum(axis=1).astype(np.int32)
    got = check_walk((qc, qs, qn, rows, codesT, norms2, scales), 8)
    assert (got == got[..., :1]).all()
    want = plain((qc, qs, qn, rows, codesT, norms2, scales))
    np.testing.assert_array_equal(np.argsort(got, axis=-1, kind="stable"),
                                  np.argsort(want, axis=-1, kind="stable"))


def test_out_of_range_rows_give_nan_rows():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 6, (8, 4)).astype(np.int32)
    rows[0, 0], rows[3, 2], rows[5, 1], rows[7, 3] = -1, 6, -2**31, 2**31 - 1
    check_walk(sq8(4, C=6, d=24, pad=20, Q=8, nprobe=4, rows=rows), 8)


@settings(max_examples=40, deadline=None)
@given(
    Q=st.integers(1, 24),
    nprobe=st.integers(1, 10),
    C=st.integers(1, 12),
    d=st.sampled_from([4, 8, 20, 64]),
    pad=st.sampled_from([4, 12, 36]),
    kc=st.sampled_from([4, 8, 12]),
    hot=st.floats(0.0, 1.0),
    seed=st.integers(0, 2**31 - 1),
)
def test_walk_random_rows(Q, nprobe, C, d, pad, kc, hot, seed):
    """Random rows with a hot slab taking a share ``hot`` of the pairs."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, C, (Q, nprobe))
    rows = np.where(rng.random((Q, nprobe)) < hot, C // 2, rows).astype(np.int32)
    check_walk(sq8(seed, C=C, d=d, pad=pad, Q=Q, nprobe=nprobe, rows=rows), kc)


@pytest.mark.parametrize("d, pad, Q, nprobe", [(128, 336, 6, 8), (20, 240, 9, 3),
                                               (960, 528, 3, 4)])
def test_walk_agrees_with_jax_oracle(d, pad, Q, nprobe):
    """The JAX package's oracle on the same inputs (the port's quantized
    queries, bit-equal to the JAX package's: tests/test_torch_int8mxu.py)."""
    args = sq8(5, C=7, d=d, pad=pad, Q=Q, nprobe=nprobe)
    got = score_by_schedule(*args, kc=16)
    want = np.asarray(jr.int8mxu_rerank_oracle(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.argsort(got, axis=-1, kind="stable"),
                                  np.argsort(want, axis=-1, kind="stable"))


def test_cpu_path_takes_a_4_byte_aligned_view():
    """The card's bulk copies need 16-byte aligned codes and |r|^2 tables
    (the CUDA wrapper raises otherwise); the CPU path reads any aligned
    view, here both 4 bytes off a 16-byte boundary."""
    qc, qs, qn, rows, codesT, norms2, scales = (
        torch.from_numpy(a) for a in sq8(6, C=5, d=32, pad=16, Q=4, nprobe=3))
    views = []
    for t in (codesT, norms2):
        nbytes = t.numel() * t.element_size()
        buf = torch.empty(nbytes + 16, dtype=torch.int8)
        shift = (4 - buf.data_ptr()) % 16
        v = buf[shift : shift + nbytes].view(t.dtype).view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4
        views.append(v)
    got = tr.padded_rerank_distances_int8mxu(qc, qs, qn, rows, views[0], views[1], scales)
    want = tr.padded_rerank_distances_int8mxu(qc, qs, qn, rows, codesT, norms2, scales)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
