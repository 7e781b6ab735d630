"""What the tensor-core replica and nearest-centroid kernels rely on, checked
on the CPU: zero-padding d to whole wgmma k-steps (``pad_depth``, which
the bf16 wrapper applies) changes no replica list and no nearest centroid
of the plain versions, and every C entry point of ``csrc/*.cu`` is
declared to ctypes with its number of arguments (parsed from the sources:
no ``nvcc`` needed).  The kernels themselves run only on the card
(``chip_smoke.py``); its replica comparator is checked here on rows made
by hand."""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from spfresh_tpu_torch.ops import _build
from spfresh_tpu_torch.ops import replica as trp
from spfresh_tpu_torch.ops.distances import pairwise_distance

torch.set_num_threads(2)


def _case(seed, n, C, d, dtype):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    cents = X[rng.integers(0, n, C)] + 0.1 * rng.standard_normal((C, d)).astype(np.float32)
    base = torch.from_numpy(rng.integers(0, C, n).astype(np.int32))
    return torch.from_numpy(X).to(dtype), base, torch.from_numpy(cents).to(dtype)


DTYPES = [torch.float32, torch.bfloat16]
# f32 rounding: the expansion |x|^2 + |c|^2 - 2 x.c sums d products in
# another blocking once zero columns are appended, so a distance moves by a
# few ulps of its terms |x|^2 + |c|^2, not of the (cancelled) distance.
TERMS_RTOL = 1e-6


def _sq(t):
    return (t.float() ** 2).sum(1)


def _assert_rounding(got, want, terms):
    err = (got - want).abs()
    assert bool((err <= TERMS_RTOL * terms).all()), float((err / terms).max())


@pytest.mark.parametrize("d", [5, 16, 96, 100])
def test_pad_depth(d):
    X = torch.randn(7, d).to(torch.bfloat16)
    P = trp.pad_depth(X)
    assert P.shape == (7, -(-d // 16) * 16)
    if d % 16 == 0:
        assert P is X
    assert torch.equal(P[:, :d], X)
    assert not P[:, d:].any()


@pytest.mark.parametrize("d", [5, 96, 100])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lam", [0.0, 0.5])
@pytest.mark.parametrize("db_given", [False, True])
def test_zero_padded_depth_keeps_replicas(d, dtype, lam, db_given):
    X, base, cents = _case(3, 400, 90, d, dtype)
    db = None
    if db_given:
        db = pairwise_distance(X, cents).gather(1, base.long()[:, None])[:, 0]
    i0, r0 = trp.replica_topk_plain(X, base, cents, 1.3, 3, db=db, soar_lambda=lam)
    i1, r1 = trp.replica_topk_plain(trp.pad_depth(X), base, trp.pad_depth(cents), 1.3, 3, db=db,
                                    soar_lambda=lam)
    fin = torch.isfinite(r0)
    assert int(fin.sum()) > 100  # the check admits replicas
    assert torch.equal(fin, torch.isfinite(r1))
    assert torch.equal(i0[fin], i1[fin])
    terms = _sq(X)[:, None] + _sq(cents)[i0.clamp_min(0).long()]
    _assert_rounding(r1[fin], r0[fin], terms[fin])


@pytest.mark.parametrize("d", [5, 96, 100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_padded_depth_keeps_nearest(d, dtype):
    X, _, cents = _case(5, 500, 120, d, dtype)
    b0, d0 = trp.nearest_centroid_plain(X, cents)
    b1, d1 = trp.nearest_centroid_plain(trp.pad_depth(X), trp.pad_depth(cents))
    assert torch.equal(b0, b1)
    _assert_rounding(d1, d0, _sq(X) + _sq(cents)[b0.long()])


def _entry_points():
    """{name: argument count} of every ``extern "C"`` function in csrc/*.cu."""
    found = {}
    pattern = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(spf_\w+)\s*\(([^)]*)\)', re.S)
    for src in _build.sources():
        for name, args in pattern.findall(src.read_text()):
            parts = [a.strip() for a in args.split(",")]
            found[name] = 0 if parts in ([""], ["void"]) else len(parts)
    return found


class _Recorder:
    """Stands in for the loaded library: records what _declare sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, types.SimpleNamespace())


ENTRY_POINTS = _entry_points()


def test_every_entry_point_is_declared():
    rec = _Recorder()
    _build._declare(rec)
    assert set(rec.fns) == set(ENTRY_POINTS)
    assert len(ENTRY_POINTS) >= 7


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_signature(name):
    rec = _Recorder()
    _build._declare(rec)
    assert len(rec.fns[name].argtypes) == ENTRY_POINTS[name], name
    assert hasattr(rec.fns[name], "restype")


def test_sources_are_the_package_csrc():
    assert all(Path(s).parent == _build.CSRC for s in _build.sources())


LAM = 0.5  # the rows' SOAR lambda
# (a, D) of the candidates of _closure_row: 1-3 admitted, 4 at the bound
# (its D replaced per test), 5 admitted and ranked after 3, 6 not admitted
# (a > 0.5, so CC < D).
CANDIDATES = [(0.0, 1.1), (0.0, 1.2), (-0.7, 1.8), (0.0, None), (-0.9, 1.7), (0.8, 1.9)]


def _closure_row(at_bound_d, cands=CANDIDATES):
    """One point x = 0 with base c_b = (1, 0) (db 1) and candidates c = (a,
    y), D = a^2 + y^2, CC = D - 2a + 1 (admitted for a <= 0.5 and D < 2),
    SOAR rank D + a^2 / 2; bt 2.  Candidate 4's D is ``at_bound_d``."""
    cand = [(a, at_bound_d if D is None else D) for a, D in cands]
    C = np.array([[1.0, 0.0]] + [[a, np.sqrt(D - a * a)] for a, D in cand])
    ranks = {j + 1: D + LAM * a * a for j, (a, D) in enumerate(cand)}
    return np.zeros((1, 2)), np.zeros(1, dtype=np.int32), C, ranks


def _lists(ranks, ids):
    return (np.array([ids], dtype=np.int32),
            np.array([[np.float32(ranks[j]) for j in ids]], dtype=np.float32))


def _compare(X, base, C, kernel, plain):
    return chip_smoke.replica_compare(X, base, C, 2.0, *kernel, *plain, LAM)


def test_replica_compare_takes_the_slot_a_bound_tie_freed():
    # Plain keeps candidate 4, 1e-7 under the bound bt*db = 2; the kernel
    # rejects it and its third slot takes candidate 3 (rank 2.045 > 2).
    X, base, C, ranks = _closure_row(2.0 * (1 - 1e-7), CANDIDATES[:4])
    kernel, plain = _lists(ranks, [1, 2, 3]), _lists(ranks, [1, 2, 4])
    rows, _, rel = _compare(X, base, C, kernel, plain)
    assert rows == 1 and rel == 0.0
    rows, _, _ = _compare(X, base, C, plain, kernel)
    assert rows == 1


def test_replica_compare_refuses_a_difference_without_a_tie():
    # Candidate 4 (D 1.5) is well inside the bound: a list that drops it
    # for candidate 3 is wrong.
    X, base, C, ranks = _closure_row(1.5, CANDIDATES[:4])
    with pytest.raises(AssertionError, match="without a near-tie"):
        _compare(X, base, C, _lists(ranks, [1, 2, 3]), _lists(ranks, [1, 2, 4]))


def test_replica_compare_refuses_a_fill_that_is_not_admitted():
    # The slot freed by candidate 4 goes to candidate 6 (rank 2.22, past
    # the freed slot as a real fill would be), whose CC < D.
    X, base, C, ranks = _closure_row(2.0 * (1 - 1e-7))
    with pytest.raises(AssertionError, match="not admitted"):
        _compare(X, base, C, _lists(ranks, [1, 2, 6]), _lists(ranks, [1, 2, 4]))


def test_replica_compare_refuses_a_fill_with_a_wrong_rank():
    # Candidate 3 fills the freed slot but reports rank 2.3 (2.045 in f64).
    X, base, C, ranks = _closure_row(2.0 * (1 - 1e-7), CANDIDATES[:4])
    kernel = _lists(ranks, [1, 2, 3])
    kernel[1][0, 2] = 2.3
    with pytest.raises(AssertionError, match="in f64"):
        _compare(X, base, C, kernel, _lists(ranks, [1, 2, 4]))


def test_replica_compare_refuses_a_fill_that_passes_over_a_candidate():
    # Candidate 5 (rank 2.105) fills the freed slot, but candidate 3 (rank
    # 2.045), admitted and ranked before it, is in neither list.
    X, base, C, ranks = _closure_row(2.0 * (1 - 1e-7), CANDIDATES[:5])
    with pytest.raises(AssertionError, match="passes over admitted \\[3\\]"):
        _compare(X, base, C, _lists(ranks, [1, 2, 5]), _lists(ranks, [1, 2, 4]))


def test_replica_compare_holds_ranks_to_the_terms_on_request():
    # The same lists with lambda 0 (rank = D): candidate 2's rank off by
    # 2e-4 of D passes under the terms rule only if 2e-4 * D stays within
    # NEAREST_RTOL of |x|^2 + |c|^2 (= D here, x = 0): it does not.
    X, base, C, ranks = _closure_row(1.5, CANDIDATES[:4])
    ranks = {j: float(((C[j] - X[0]) ** 2).sum()) for j in ranks}
    kernel, plain = _lists(ranks, [1, 2, 4]), _lists(ranks, [1, 2, 4])
    kernel[1][0, 1] *= 1 + 2e-4
    with pytest.raises(AssertionError, match="rank rel err"):
        chip_smoke.replica_compare(X, base, C, 2.0, *kernel, *plain, 0.0, terms=True)
    with pytest.raises(AssertionError, match="rank rel err"):
        chip_smoke.replica_compare(X, base, C, 2.0, *kernel, *plain, 0.0)
    kernel[1][0, 1] = plain[1][0, 1] * (1 + 5e-6)
    _, _, rel = chip_smoke.replica_compare(X, base, C, 2.0, *kernel, *plain, 0.0, terms=True)
    assert 0 < rel <= chip_smoke.NEAREST_RTOL
