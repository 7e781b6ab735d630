"""Slab rerank: the port's plain version (what a CPU tensor runs) against
the JAX package's oracle ``rerank._emulate`` and its Pallas kernel in
interpret mode, plus the wrapper's input contract."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spfresh_tpu.ops.pallas import rerank as jr
from spfresh_tpu_torch.ops import rerank as tr

torch.set_num_threads(2)


def _case(seed, Q=6, nprobe=5, C=9, pad=16, d=128, bf16=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    v = rng.standard_normal((C, pad, d)).astype(np.float32)
    if bf16:
        v = v.astype(ml_dtypes.bfloat16)
    rows = rng.integers(0, C, (Q, nprobe)).astype(np.int32)
    tv = torch.from_numpy(v.astype(np.float32))
    if bf16:
        tv = tv.to(torch.bfloat16)  # the same bf16 values
    return q, rows, v, torch.from_numpy(q), torch.from_numpy(rows), tv


@pytest.mark.parametrize("metric", ["Euclidean", "Manhattan", "Chebyshev"])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_matches_emulate(metric, bf16):
    q, rows, v, tq, trows, tv = _case(1, bf16=bf16)
    before = tr.launches
    got = tr.padded_rerank_distances(tq, trows, tv, metric)
    want = np.asarray(jr._emulate(jnp.asarray(q), jnp.asarray(rows), jnp.asarray(v), metric))
    assert got.shape == (6, 5, 16) and got.dtype == torch.float32
    # rtol 1e-5: f32 sums of d = 128 terms in another order (the max of
    # Chebyshev is order-free and comes out exact).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert tr.launches == before  # a CPU tensor never counts a kernel launch


def test_plain_matches_pallas_kernel_interpret():
    q, rows, v, tq, trows, tv = _case(2, Q=8, nprobe=4, C=10, pad=16)
    want = np.asarray(jr.padded_rerank_distances(
        jnp.asarray(q), jnp.asarray(rows), jnp.asarray(v), "Euclidean", interpret=True))
    got = tr.padded_rerank_distances(tq, trows, tv, "Euclidean")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)  # f32 summation order


def test_chunked_plain_equals_one_shot(monkeypatch):
    _, _, _, tq, trows, tv = _case(3, Q=11)
    one = tr.padded_rerank_distances_plain(tq, trows, tv)
    monkeypatch.setattr(tr, "PLAIN_CHUNK_BYTES", 1)  # one query per chunk
    chunked = tr.padded_rerank_distances_plain(tq, trows, tv)
    torch.testing.assert_close(one, chunked, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    _, _, _, tq, trows, tv = _case(4)
    with pytest.raises(TypeError, match="int32"):
        tr.padded_rerank_distances(tq, trows.long(), tv)
    with pytest.raises(TypeError, match="float32"):
        tr.padded_rerank_distances(tq.double(), trows, tv)
    with pytest.raises(TypeError, match="slabs"):
        tr.padded_rerank_distances(tq, trows, tv.to(torch.float16))
    with pytest.raises(ValueError, match="width"):
        tr.padded_rerank_distances(tq[:, :64], trows, tv)
    with pytest.raises(ValueError, match="row-table"):
        tr.padded_rerank_distances(tq[:3], trows, tv)
    with pytest.raises(ValueError, match="metric"):
        tr.padded_rerank_distances(tq, trows, tv, "cosine")


def test_non_cpu_tensor_launches_or_raises():
    """A tensor off the CPU never takes the plain version: on a device with
    no kernel the wrapper raises."""
    _, _, _, tq, trows, tv = _case(5)
    with pytest.raises(ValueError, match="no rerank for device"):
        tr.padded_rerank_distances(tq.to("meta"), trows.to("meta"), tv.to("meta"))
