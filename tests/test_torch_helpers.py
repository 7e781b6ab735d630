"""The port's two host helpers against the JAX package's: the f64
single-pair distance (twin of tests/test_distances.py's
``test_distance_f64_host_path``, the same inputs through both packages,
results equal as ``np.float64``) and the ``DtypePolicy`` accessors for
every storage dtype (item sizes equal; ``to_storage``/``to_accum`` keep a
tensor's device and move nothing otherwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfresh_tpu.core.dtypes import DtypePolicy as JPolicy
from spfresh_tpu.ops.distances import distance_f64 as jdistance_f64
from spfresh_tpu_torch.core.dtypes import DEFAULT_POLICY, DtypePolicy
from spfresh_tpu_torch.ops.distances import distance_f64


def test_distance_f64_matches_jax():
    u = np.array([1.0, 2.0, 3.0], np.float64)
    v = np.array([4.0, 6.0, 3.0], np.float64)
    a = np.array([1e9, 0.0])
    b = np.array([1e9 + 1.0, 0.0])  # f64 keeps the 1.0 that f32 would lose
    cases = [(u, v, "Euclidean", 25.0), (u, v, "Manhattan", 7.0), (u, v, "Chebyshev", 4.0),
             (a, b, "Euclidean", 1.0), (u.astype(np.float32), v, "euclidean", 25.0)]
    for x, y, metric, want in cases:
        got = distance_f64(x, y, metric)
        ref = jdistance_f64(x, y, metric)
        assert isinstance(got, np.float64) and isinstance(ref, np.float64)
        assert got == ref == want, (metric, got, ref)
    assert distance_f64(u, v) == jdistance_f64(u, v)  # default metric
    for mod in (distance_f64, jdistance_f64):
        with pytest.raises(ValueError):
            mod(u, v[:2])
        with pytest.raises(ValueError):
            mod(u, v, "Cosine")


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_dtype_policy_accessors_match_jax(storage):
    port, ref = DtypePolicy(storage), JPolicy(storage)
    assert port.accum_dtype is torch.float32 and ref.accum_dtype == jnp.float32
    assert port.storage_itemsize == ref.storage_itemsize
    assert port.storage_dtype.itemsize == jnp.dtype(ref.storage_dtype).itemsize
    x = np.array([[0.5, -1.25, 3.0]], np.float32)
    s = port.to_storage(x)
    assert s.dtype == port.storage_dtype and s.device.type == "cpu"
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(ref.to_storage(x), np.float32))
    a = port.to_accum([1, 2, 3])
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref.to_accum([1, 2, 3])))
    # A tensor keeps its device unless one is named; "meta" stands in for a
    # card, which the CPU tests do not have.
    t = torch.zeros(4, device="meta")
    assert port.to_storage(t).device.type == "meta"
    assert port.to_accum(t).device.type == "meta"
    assert port.to_storage(torch.ones(4), device="meta").device.type == "meta"
    assert port.to_accum(x, device="meta").device.type == "meta"
    assert DEFAULT_POLICY == DtypePolicy() and DEFAULT_POLICY.storage_dtype is torch.float32
