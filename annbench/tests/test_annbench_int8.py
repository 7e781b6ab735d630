"""Residual int8 storage: the reference's stored copies on a posting worked
by hand, and a tiny int8 index through the windowed stage 1 run whole on the
CPU, judged correct, while the control and the fault ``sq8_truncate`` are
not."""

import pytest
import torch

from annbench.control import ReferenceSystem
from annbench.faults import sq8_truncate
from annbench.reference import sq8
from annbench.testing import run_small

CELL = "bigann4m-int8.batch"


def test_stored_copies_by_hand():
    # Posting 0 (centroid row 1, all ones): row 0's residual 254 sets the
    # scale 254 * f32(1/127) = 2.0; residuals 5, 7, -3 halve to 2.5, 3.5,
    # -1.5 and round half to even (2, 4, -2).  Row 7's 6.015625 lies halfway
    # between two bfloat16 values and goes to 6.0 before quantizing (code 2,
    # not 3).  Posting 1 (centroid row 4, zeros): scale 4.0, so row 2 is
    # stored as 3 there and as 4 here.  Posting 2: every member equals its
    # centroid, scale 1.0.
    rows = torch.tensor([[255, 6, 8, -2], [1, 1, 1, 1], [3, 3, 3, 3], [508, 0, 0, 0],
                         [0, 0, 0, 0], [7, 7, 7, 7], [7, 7, 7, 7], [6.015625, 1, 1, 1]])
    cent = rows[[1, 4, 5]]
    ids = torch.tensor([0, 1, 2, 7, 2, 3, 4, 5, 6])
    posts = torch.tensor([0, 0, 0, 0, 1, 1, 1, 2, 2])
    scales = sq8.posting_scales(rows, cent, ids, posts)
    assert scales.tolist() == [2.0, 4.0, 1.0]
    assert sq8.codes(rows, cent, scales, ids, posts).tolist() == [
        [127, 2, 4, -2], [0, 0, 0, 0], [1, 1, 1, 1], [2, 0, 0, 0],
        [1, 1, 1, 1], [127, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
    assert sq8.stored(rows, cent, scales, ids, posts).tolist() == [
        [255, 5, 9, -3], [1, 1, 1, 1], [3, 3, 3, 3], [5, 1, 1, 1],
        [4, 4, 4, 4], [508, 0, 0, 0], [0, 0, 0, 0], [7, 7, 7, 7], [7, 7, 7, 7]]
    # Row 2's two copies lie at two distances from the origin.
    d = sq8.copy_distances(torch.zeros(1, 4), torch.zeros(2, dtype=torch.int64), rows, cent,
                           scales, ids[[2, 4]], posts[[2, 4]])
    assert d.dtype == torch.float64 and d.tolist() == [36.0, 64.0]


@pytest.fixture
def windowed(monkeypatch):
    """Stage 1 takes the windowed route at the tiny size; the calls are
    counted."""
    from spfresh_tpu_torch.ops import centroid_scan, topk

    calls = []
    real = centroid_scan.windowed_centroid_topk

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(topk, "LARGE_C_THRESHOLD", 16)
    monkeypatch.setattr(centroid_scan, "windowed_centroid_topk", counted)
    return calls


def test_windowed_int8_run_is_correct(windowed):
    out = run_small(CELL)
    assert windowed, "stage 1 did not take the windowed route"
    assert out.correct, out.checks
    assert out.checks["dist_err"][0] < 1e-5 and out.checks["missed"][0] == 0


@pytest.mark.parametrize("broken", ["control", "sq8_truncate"])
def test_control_and_truncated_codes_are_not_correct(windowed, broken):
    if broken == "control":
        out = run_small(CELL, system_factory=ReferenceSystem)
    else:
        with sq8_truncate():
            out = run_small(CELL)
        assert windowed
    assert not out.correct
    assert out.checks["dist_err"][0] > out.checks["dist_err"][1]
