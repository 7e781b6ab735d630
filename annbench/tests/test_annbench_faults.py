"""The comparison fails the control and planted faults: the runs below skip
the look for a card and drive the rest of a run at a tiny size on the CPU
with the timed path broken underneath."""

import numpy as np
import pytest

from annbench.control import ReferenceSystem
from annbench.faults import insert_anywhere
from annbench.testing import run_small

CELLS = ["sift1m-bf16.batch", "sift1m-bf16.online", "sift1m-spfresh.churn",
         "bigann4m-int8.batch"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = run_small(name, system_factory=ReferenceSystem)
    assert not out.correct
    assert out.checks["dist_err"][0] > out.checks["dist_err"][1]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out(name, monkeypatch):
    from spfresh_tpu_torch.index import spann

    real = spann._search_padded

    def half(queries, view, **kw):
        ids, d = real(queries, view, **kw)
        keep = max(1, ids.shape[0] // 2) if ids.shape[0] > 1 else ids.shape[0]
        return ids[:keep], d[:keep]

    monkeypatch.setattr(spann, "_search_padded", half)
    out = run_small(name)
    assert not out.correct and out.checks["wrong"][0] > 0


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced(name, monkeypatch):
    from spfresh_tpu_torch.index import spann

    real = spann._search_padded

    def altered(queries, view, **kw):
        ids, d = real(queries, view, **kw)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % 2999  # another corpus row, same distance
        return ids, d

    monkeypatch.setattr(spann, "_search_padded", altered)
    out = run_small(name)
    assert not out.correct
    assert out.checks["dist_err"][0] > out.checks["dist_err"][1]


def test_update_that_leaves_the_state_unchanged(monkeypatch):
    from spfresh_tpu_torch.lire import fresh

    monkeypatch.setattr(fresh.SpFreshIndex, "insert_batch",
                        lambda self, vecs, ids: [0] * len(ids))
    monkeypatch.setattr(fresh.SpFreshIndex, "delete_batch",
                        lambda self, ids: len(np.asarray(ids)))
    out = run_small("sift1m-spfresh.churn")
    assert not out.correct and out.checks["wrong"][0] > 0



def test_insert_into_a_random_posting():
    """Inserts routed to a random posting instead of the nearest: the
    searches' own postings still hold them, so only ``stray`` sees it."""
    with insert_anywhere():
        out = run_small("sift1m-spfresh.churn")
    assert not out.correct
    assert out.checks["stray"][0] > out.checks["stray"][1]
