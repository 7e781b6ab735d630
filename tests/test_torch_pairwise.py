"""L1/Linf pairwise distances: the port's plain version (what a CPU tensor
runs) against the JAX package's Pallas kernel in interpret mode and its
``pairwise_distance``, in f32 and bf16; the routing of
``ops.distances.pairwise_distance``; the wrapper's checks."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spfresh_tpu.ops import distances as jd
from spfresh_tpu.ops.pallas.pairwise import pallas_l1_linf_pairwise
from spfresh_tpu_torch.ops import distances as td
from spfresh_tpu_torch.ops import pairwise as tp

torch.set_num_threads(2)

SHAPES = [(16, 128, 128), (19, 131, 70), (3, 5, 960), (21, 140, 960)]


def _xy(seed, n, m, d, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    if dtype == "bfloat16":
        x, y = x.astype(ml_dtypes.bfloat16), y.astype(ml_dtypes.bfloat16)

    def t(a):
        out = torch.from_numpy(np.asarray(a, np.float32))
        return out.to(torch.bfloat16) if dtype == "bfloat16" else out

    return (x, y), (t(x), t(y))


def _assert_agree(got, want, metric):
    if metric == "Chebyshev":
        np.testing.assert_array_equal(got, want)  # a maximum is order-free
    else:
        # f32 sums of d terms of |x - y| in another order; the tolerance of
        # tests/test_pallas_pairwise.py.
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["Manhattan", "Chebyshev"])
@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(metric, n, m, d, dtype):
    (x, y), (tx, ty) = _xy(n * m + d, n, m, d, dtype)
    want = np.asarray(pallas_l1_linf_pairwise(jnp.asarray(x), jnp.asarray(y), metric,
                                              interpret=True))
    got = tp.l1_linf_pairwise(tx, ty, metric)
    assert got.dtype == torch.float32 and got.shape == (n, m)
    _assert_agree(got.numpy(), want, metric)


@pytest.mark.parametrize("metric", ["Manhattan", "Chebyshev"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_pairwise_distance(metric, dtype):
    (x, y), (tx, ty) = _xy(3, 40, 90, 960, dtype)
    want = np.asarray(jd.pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric))
    _assert_agree(tp.l1_linf_pairwise_plain(tx, ty, metric).numpy(), want, metric)
    # Past the kernel threshold a CPU tensor still takes the elementwise form.
    assert 40 * 90 * 960 < td.L1_LINF_KERNEL_OPS
    before = tp.launches
    _assert_agree(td.pairwise_distance(tx, ty, metric).numpy(), want, metric)
    assert tp.launches == before


def test_cpu_route_at_kernel_sizes_launches_nothing():
    """At n*m*d >= L1_LINF_KERNEL_OPS a CPU tensor keeps the elementwise
    form: the kernel is reached from CUDA tensors only."""
    (_, _), (tx, ty) = _xy(4, 64, 80, 960, "float32")
    assert 64 * 80 * 960 >= td.L1_LINF_KERNEL_OPS
    before = tp.launches
    got = td.pairwise_distance(tx, ty, "Manhattan")
    assert tp.launches == before
    torch.testing.assert_close(got, tp.l1_linf_pairwise_plain(tx, ty, "Manhattan"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("metric,dev,n,routed", [
    ("Manhattan", "cuda", 4096, True),         # n*m*d = 2^22 exactly
    ("Chebyshev", "cuda", 4096, True),
    ("Manhattan", "cuda", 4095, False),        # one row short of the threshold
    ("Euclidean", "cuda", 4096, False),        # squared L2 has its matmul form
    ("Manhattan", "cpu", 1 << 20, False),      # CPU tensors keep the elementwise form
])
def test_kernel_route(metric, dev, n, routed):
    """The routing rule alone, on shape-and-device stand-ins (no card here):
    L1/Linf on CUDA from 2^22 element operations on."""
    from types import SimpleNamespace

    x = SimpleNamespace(device=torch.device(dev), shape=(n, 32))
    y = SimpleNamespace(device=torch.device(dev), shape=(32, 32))
    assert td.takes_l1_linf_kernel(x, y, metric) is routed


def test_wrapper_rejects_bad_inputs():
    (_, _), (tx, ty) = _xy(5, 8, 9, 16, "float32")
    with pytest.raises(ValueError, match="metric"):
        tp.l1_linf_pairwise(tx, ty, "Euclidean")
    with pytest.raises(TypeError):
        tp.l1_linf_pairwise(tx, ty.to(torch.bfloat16), "Manhattan")
    with pytest.raises(ValueError, match="expected"):
        tp.l1_linf_pairwise(tx, ty[:, :5], "Manhattan")
    with pytest.raises(ValueError, match="no L1/Linf pairwise kernel for device"):
        tp.l1_linf_pairwise(tx.to("meta"), ty.to("meta"), "Chebyshev")
