"""The plain reference against numpy brute force."""

import numpy as np
import torch

from annbench.reference.exact import exact_topk, lowp_topk, round_to


def brute(rows, queries, k, live=None):
    d = ((queries[:, None, :].astype(np.float64) - rows[None].astype(np.float64)) ** 2).sum(-1)
    if live is not None:
        d[:, ~live] = np.inf
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(d, order, 1)


def test_exact_topk_equals_numpy_brute_force():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3000, 24)).astype(np.float32)
    q = rng.standard_normal((50, 24)).astype(np.float32)
    live = rng.random(3000) > 0.3
    ids, d = exact_topk(torch.from_numpy(rows), torch.from_numpy(q), 10,
                        live=torch.from_numpy(live))
    bi, bd = brute(rows, q, 10, live)
    assert (ids.numpy() == bi).all()
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_exact_topk_on_stored_rows_and_ties_to_the_lower_row():
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((500, 16)).astype(np.float32)
    rows[300] = rows[7]                      # a tie: row 7 comes first
    q = rows[7:8] + 0.001
    ids, _ = exact_topk(torch.from_numpy(rows), torch.from_numpy(q), 2)
    assert ids.tolist() == [[7, 300]]
    stored = round_to(torch.from_numpy(rows), torch.bfloat16).numpy()
    qs = rng.standard_normal((20, 16)).astype(np.float32)
    ids, d = exact_topk(torch.from_numpy(rows), torch.from_numpy(qs), 5,
                        round_rows=torch.bfloat16)
    bi, bd = brute(stored, qs, 5)
    assert (ids.numpy() == bi).all()
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_lowp_search_ranks_the_rounded_rows():
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((400, 16)).astype(np.float32)
    q = rng.standard_normal((10, 16)).astype(np.float32)
    ids, d = lowp_topk(torch.from_numpy(rows), torch.from_numpy(q), 5)
    r8 = round_to(torch.from_numpy(rows), torch.float8_e4m3fn).numpy()
    q8 = round_to(torch.from_numpy(q), torch.float8_e4m3fn).numpy()
    bi, bd = brute(r8, q8, 5)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-4, atol=1e-4)
    assert (np.sort(ids.numpy(), 1) == np.sort(bi, 1)).mean() > 0.9
