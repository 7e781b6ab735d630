"""Closure-replica top-k: the port's plain version (what a CPU tensor runs)
against the JAX package's Pallas kernel in interpret mode and its XLA
closure pass, with SOAR on and off and with a caller-supplied db."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spfresh_tpu.clustering.hierarchical import _final_replica_pass
from spfresh_tpu.ops.pallas.replica import pallas_replica_topk
from spfresh_tpu_torch.ops import replica as trp

torch.set_num_threads(2)


def _case(seed, n, C, d, dtype):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    cents = X[rng.integers(0, n, C)] + 0.1 * rng.standard_normal((C, d)).astype(np.float32)
    base = rng.integers(0, C, n).astype(np.int32)
    if dtype == "bfloat16":
        X = X.astype(ml_dtypes.bfloat16)
        cents = cents.astype(ml_dtypes.bfloat16)

    def t(a):
        out = torch.from_numpy(np.asarray(a, np.float32))
        return out.to(torch.bfloat16) if dtype == "bfloat16" else out

    return (X, base, cents), (t(X), torch.from_numpy(base), t(cents))


def _assert_same_replicas(ki, kd, wi, wd):
    """Same admitted set; ids identical away from near-ties; ranks within
    rtol 1e-5.  The two sides sum the expansion's dot products in another
    order, so ranks differ in the last ulps of |x|^2 + |c|^2 (~2 d ~ 256
    at d = 128, eps * 256 ~ 3e-5 per rounding): atol 5e-4 covers that
    cancellation down to small distances, and ids may swap only where
    their ranks agree to 1e-4."""
    fin = np.isfinite(wd)
    assert np.array_equal(fin, np.isfinite(kd))
    eq = ki[fin] == wi[fin]
    if not eq.all():
        assert np.allclose(kd[fin][~eq], wd[fin][~eq], rtol=1e-4)
        assert eq.mean() > 0.999
    np.testing.assert_allclose(kd[fin], wd[fin], rtol=1e-5, atol=5e-4)


CASES = [
    (500, 37, 19, 3, "float32"),
    (300, 130, 64, 7, "float32"),
    (700, 600, 33, 1, "float32"),
    (400, 50, 128, 3, "bfloat16"),
    (513, 700, 96, 4, "bfloat16"),
]


@pytest.mark.parametrize("n,C,d,ne,dtype", CASES)
@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_plain_matches_pallas_interpret(n, C, d, ne, dtype, lam):
    (X, base, cents), (tX, tb, tc) = _case(42, n, C, d, dtype)
    bt = 1.3
    wi, wd = pallas_replica_topk(jnp.asarray(X), jnp.asarray(base), jnp.asarray(cents), bt, ne,
                                 soar_lambda=lam, interpret=True)
    ki, kd = trp.replica_topk(tX, tb, tc, bt, ne, soar_lambda=lam)
    _assert_same_replicas(ki.numpy(), kd.numpy(), np.asarray(wi), np.asarray(wd))


@pytest.mark.parametrize("n,C,d,ne,dtype", CASES)
@pytest.mark.parametrize("lam", [0.0, 1.5])
def test_plain_matches_xla_pass(n, C, d, ne, dtype, lam):
    (X, base, cents), (tX, tb, tc) = _case(7, n, C, d, dtype)
    bt = 1.25
    wi, wd = _final_replica_pass(jnp.asarray(X), jnp.asarray(base), jnp.asarray(cents),
                                 "Euclidean", jnp.float32(bt), ne, soar_lambda=lam)
    ki, kd = trp.replica_topk(tX, tb, tc, bt, ne, soar_lambda=lam)
    _assert_same_replicas(ki.numpy(), kd.numpy(), np.asarray(wi), np.asarray(wd))


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_db_contract(lam):
    """A caller-supplied dist(p, c_base) equal to the internal one gives the
    same result exactly, and matches the Pallas kernel's db= route."""
    (X, base, cents), (tX, tb, tc) = _case(9, 400, 64, 48, "float32")
    bt = 1.25
    i1, d1 = trp.replica_topk(tX, tb, tc, bt, 3, soar_lambda=lam)
    from spfresh_tpu_torch.ops.distances import pairwise_distance

    db = pairwise_distance(tX, tc).gather(1, tb.long()[:, None])[:, 0]
    i2, d2 = trp.replica_topk(tX, tb, tc, bt, 3, db=db, soar_lambda=lam)
    torch.testing.assert_close(i1, i2, rtol=0, atol=0)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    wi, wd = pallas_replica_topk(jnp.asarray(X), jnp.asarray(base), jnp.asarray(cents), bt, 3,
                                 db=jnp.asarray(db.numpy()), soar_lambda=lam, interpret=True)
    _assert_same_replicas(i2.numpy(), d2.numpy(), np.asarray(wi), np.asarray(wd))


def test_ties_go_to_the_lower_id_and_soar_prefers_orthogonal():
    """Two admitted candidates at equal distance: plain ranking keeps the
    lower id; SOAR picks the one whose residual is orthogonal to the
    primary's."""
    x = torch.zeros((1, 8))
    cents = torch.zeros((3, 8))
    cents[0, 0] = 1.0   # base: r1 = -e0, db = 1
    cents[1, 0] = -2.0  # collinear candidate (id 1): D = 4
    cents[2, 1] = 2.0   # orthogonal candidate (id 2): D = 4
    base = torch.zeros(1, dtype=torch.int32)
    i_plain, _ = trp.replica_topk(x, base, cents, 10.0, 1)
    i_soar, _ = trp.replica_topk(x, base, cents, 10.0, 1, soar_lambda=1.0)
    assert int(i_plain[0, 0]) == 1
    assert int(i_soar[0, 0]) == 2


def test_row_tiles_are_exact(monkeypatch):
    _, (tX, tb, tc) = _case(11, 900, 130, 48, "float32")
    i0, d0 = trp.replica_topk_plain(tX, tb, tc, 1.3, 3)
    monkeypatch.setattr(trp, "PLAIN_TILE_ELEMS", 1)  # the 256-row floor: tiles 256/256/256/132
    i1, d1 = trp.replica_topk_plain(tX, tb, tc, 1.3, 3)
    fin = torch.isfinite(d0)
    assert torch.equal(fin, torch.isfinite(d1))
    torch.testing.assert_close(i0[fin], i1[fin], rtol=0, atol=0)
    torch.testing.assert_close(d0, d1, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    _, (tX, tb, tc) = _case(12, 50, 10, 8, "float32")
    with pytest.raises(TypeError):
        trp.replica_topk(tX, tb, tc.to(torch.bfloat16), 1.1, 2)
    with pytest.raises(ValueError, match="base"):
        trp.replica_topk(tX, tb.long(), tc, 1.1, 2)
    with pytest.raises(ValueError, match="n_extra"):
        trp.replica_topk(tX, tb, tc, 1.1, 11)
    with pytest.raises(ValueError, match="db"):
        trp.replica_topk(tX, tb, tc, 1.1, 2, db=torch.zeros(3))
    with pytest.raises(ValueError, match="no replica kernel for device"):
        trp.replica_topk(tX.to("meta"), tb.to("meta"), tc.to("meta"), 1.1, 2)
