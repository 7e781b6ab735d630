"""The tie-stable row select (``ops/topk.py::smallest_k``; the kernel in
``csrc/topk_select.cu``) on the CPU: the wrapper's argument checks, the
CPU route through the plain version, the plain version against
``lax.top_k`` on rows built to stress the order, and the kernel's
algorithm (range prefix, radix passes over key then column, rounds of
ranks, compaction, sort) walked step for step in numpy at scaled-down
(n, k) shapes of every route that calls it on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfresh_tpu.ops import topk as jt
from spfresh_tpu_torch.ops import topk as tt
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

NAN = np.float32("nan")
NEG_NAN = -np.abs(NAN)
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, NAN, NEG_NAN], np.float32)

# Scaled-down (rows, n, k) of each caller's rows on the card (the note in
# csrc/topk_select.cu lists them at full size).
ROUTES = {
    "dense_stage1": (24, 1100, 8),          # 8,192 x 11,008, k 8
    "dense_full_probe": (6, 300, 300),      # k = n = C
    "chunked_fold": (12, 8 + 820, 8),       # nprobe + 8,192
    "windowed_minima": (16, 344, 16),       # W windows, nprobe + 8
    "windowed_centroids": (16, 256, 8),     # S * 128
    "windowed_merge": (16, 16, 8),          # 2 nprobe
    "probe_chunk_fold": (12, 80 + 68, 80),  # kk + chunk * pad
    "dedup_prefilter": (16, 268, 80),       # nprobe * pad, k * max_dup
    "dedup_prefilter_wide": (16, 268, 160),
    "dedup_final": (16, 160, 10),
    "sharded_global": (12, 32, 8),          # shards * nprobe
    "lazy_prefilter": (12, 272, 80),
    "brute_exact": (8, 1000, 10),
    "brute_two_stage": (4, 320 + 2048, 320),
    "brute_rerank": (8, 320, 10),
    "replica_elementwise": (24, 300, 3),    # n_extra of C
    "long_row": (2, 40_000, 100),           # past shared memory
    "k_one": (8, 500, 1),
    "one_column": (5, 1, 1),
}


def stress_rows(rows: int, n: int, seed: int) -> np.ndarray:
    """Distance-like rows with every ordering hazard: an all-equal row, a
    row of five values (ties everywhere), and -0.0/+0.0, +-inf and NaNs
    of both signs spread over the rest."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((rows, n)) ** 2 * 1e4).astype(np.float32)
    d[:, ::7] = d[:, ::7].round(-3)  # exact ties between columns
    if rows > 0:
        d[0] = 2.5
    if rows > 1:
        d[1] = rng.integers(0, 5, n).astype(np.float32)
    for r in range(2, rows):
        at = rng.choice(n, size=min(n, 2 * len(SPECIALS)), replace=False)
        d[r, at] = np.resize(SPECIALS, len(at))
    return d


def folded(d: np.ndarray) -> np.ndarray:
    """The row as the key sees it: + 0.0 turns -0.0 into +0.0."""
    return d + np.float32(0.0)


def order_keys(d: np.ndarray) -> np.ndarray:
    """The kernel's unsigned key (order_key): folded bits, negatives
    flipped, so unsigned order is the plain version's signed key order."""
    u = folded(d).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def lo_mask(bits: int) -> int:
    return 0xFFFFFFFF if bits >= 32 else (1 << bits) - 1


def hi_mask(known: int) -> int:
    return 0xFFFFFFFF ^ lo_mask(32 - known)


def digit_pass(values, match, shift: int, bits: int, rem: int):
    """One radix pass: the histogram of a digit over the matching entries
    and the bin where rank ``rem`` falls -> (bin, count below, count)."""
    hist = np.bincount((values[match] >> shift) & lo_mask(bits), minlength=256)
    below = np.concatenate([[0], np.cumsum(hist)])
    b = int(np.searchsorted(below, rem, side="left")) - 1
    return b, int(below[b]), int(hist[b])


def select_rank(keys: np.ndarray, rank: int, prefix: int, known: int):
    """The kernel's select_rank: the (key, column) threshold of rank
    ``rank`` (1-based)."""
    n = keys.size
    cols = np.arange(n, dtype=np.uint32)
    rem, cnt = rank, n
    while known < 32 and cnt != rem:
        bits = min(8, 32 - known)
        shift = 32 - known - bits
        b, before, cnt = digit_pass(keys, (keys & hi_mask(known)) == prefix, shift, bits, rem)
        prefix |= b << shift
        known += bits
        rem -= before
    if cnt == rem:
        return prefix | lo_mask(32 - known), 0xFFFFFFFF
    cprefix, cknown = 0, 32 - int(n - 1).bit_length()
    while cknown < 32 and cnt != rem:
        bits = min(8, 32 - cknown)
        shift = 32 - cknown - bits
        match = (keys == prefix) & ((cols & hi_mask(cknown)) == cprefix)
        b, before, cnt = digit_pass(cols, match, shift, bits, rem)
        cprefix |= b << shift
        cknown += bits
        rem -= before
    return prefix, cprefix | lo_mask(32 - cknown)


def kernel_walk(row: np.ndarray, k: int, chunk: int):
    """One row through the kernel's steps: the keys' range prefix, a round
    of ``chunk`` ranks at a time (threshold of the round's last rank, the
    pairs above the previous threshold, sorted by (key, column)), the
    values read back from the row."""
    keys = order_keys(row)
    cols = np.arange(row.size, dtype=np.uint32)
    kmin, kmax = int(keys.min()), int(keys.max())
    common = 32 - (kmin ^ kmax).bit_length()
    base = kmin & hi_mask(common)
    out = []
    prev = None
    for r0 in range(0, k, chunk):
        r1 = min(k, r0 + chunk)
        th = select_rank(keys, r1, base, common)
        sel = (keys < th[0]) | ((keys == th[0]) & (cols <= th[1]))
        if prev is not None:
            sel &= ~((keys < prev[0]) | ((keys == prev[0]) & (cols <= prev[1])))
        assert sel.sum() == r1 - r0
        got = cols[sel][np.lexsort((cols[sel], keys[sel]))]
        out.extend(got.tolist())
        prev = th
    idx = np.array(out, np.int64)
    return row[idx], idx


def tiled_walk(row: np.ndarray, k: int, tile_w: int, chunk: int):
    """The kernel's long-row form: each tile's top min(k, its columns)
    (columns of the whole row; a short tile padded with the kernel's NaN
    and column -1), then a select over the tiles' k each, its positions
    mapped back to the row's columns."""
    pad_v = np.array([0x7FFFFFFF], np.uint32).view(np.float32)[0]
    tv, ti = [], []
    for t0 in range(0, row.size, tile_w):
        tile = row[t0 : t0 + tile_w]
        kt = min(k, tile.size)
        v, i = kernel_walk(tile, kt, chunk)
        tv.append(np.concatenate([v, np.full(k - kt, pad_v, np.float32)]))
        ti.append(np.concatenate([i + t0, np.full(k - kt, -1, np.int64)]))
    v, pos = kernel_walk(np.concatenate(tv), k, chunk)
    return v, np.concatenate(ti)[pos]


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plain_version_orders_as_lax_top_k(route):
    rows, n, k = ROUTES[route]
    d = stress_rows(rows, n, seed=n + k)
    got_v, got_i = tt.smallest_k_plain(torch.from_numpy(d), k)
    # lax.top_k on the folded row (the contract's key): the same columns.
    _, want_i = jt.smallest_k(jnp.asarray(folded(d)), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # The values are the row's own, -0.0 and NaN payloads as given.
    np.testing.assert_array_equal(bits(got_v.numpy()),
                                  bits(np.take_along_axis(d, got_i.numpy(), 1)))


@pytest.mark.parametrize("chunk", [2048, 7])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kernel_walk_equals_plain_version(route, chunk):
    rows, n, k = ROUTES[route]
    d = stress_rows(rows, n, seed=3 * n + k)
    want_v, want_i = tt.smallest_k_plain(torch.from_numpy(d), k)
    for r in range(rows):
        v, i = kernel_walk(d[r], k, chunk)
        np.testing.assert_array_equal(i, want_i[r].numpy(), err_msg=f"row {r}")
        np.testing.assert_array_equal(bits(v), bits(want_v[r].numpy()), err_msg=f"row {r}")


@pytest.mark.parametrize("route", sorted(r for r, (_, n, k) in ROUTES.items() if 2 * k <= n))
def test_tiled_walk_equals_plain_version(route):
    """Tiles of n // 3 columns (at least 2 k, as the kernel's 32,768 are)."""
    rows, n, k = ROUTES[route]
    d = stress_rows(rows, n, seed=5 * n + k)
    want_v, want_i = tt.smallest_k_plain(torch.from_numpy(d), k)
    for r in range(rows):
        v, i = tiled_walk(d[r], k, max(2 * k, n // 3), chunk=2048)
        np.testing.assert_array_equal(i, want_i[r].numpy(), err_msg=f"row {r}")
        np.testing.assert_array_equal(bits(v), bits(want_v[r].numpy()), err_msg=f"row {r}")


def test_zero_signs_fold_where_lax_top_k_orders_them():
    """-0.0 and +0.0 share a key and go by column; lax.top_k's total order
    puts -0.0 first.  The port keeps the fold on every device."""
    d = np.array([[0.0, -0.0, 1.0, -0.0]], np.float32)
    v, i = tt.smallest_k(torch.from_numpy(d), 4)
    np.testing.assert_array_equal(i.numpy()[0], [0, 1, 3, 2])
    np.testing.assert_array_equal(bits(v.numpy()[0]), bits(d[0, [0, 1, 3, 2]]))
    _, raw_i = jt.smallest_k(jnp.asarray(d), 4)
    np.testing.assert_array_equal(np.asarray(raw_i)[0], [1, 3, 0, 2])


def test_cpu_tensors_take_the_plain_version():
    d = torch.from_numpy(stress_rows(6, 90, seed=1))
    before = tt.launches
    rows0 = metrics.snapshot().get("topk.select.rows", 0)
    v, i = tt.smallest_k(d, 9)
    pv, pi = tt.smallest_k_plain(d, 9)
    assert tt.launches == before == 0
    assert torch.equal(i, pi) and torch.equal(v.view(torch.int32), pv.view(torch.int32))
    assert metrics.snapshot()["topk.select.rows"] - rows0 == 6
    # Leading dimensions are rows: (2, 3, n) selects 6 rows.
    v3, i3 = tt.smallest_k(d.reshape(2, 3, 90), 9)
    assert torch.equal(i3.reshape(6, 9), i)
    assert metrics.snapshot()["topk.select.rows"] - rows0 == 12


@pytest.mark.parametrize("dists,k,err", [
    (torch.empty((3, 5), device="meta"), 6, ValueError),          # k > n
    (torch.empty((3, 5)), 6, ValueError),                         # k > n, CPU
    (torch.empty((3, 5), device="meta"), 0, ValueError),          # k < 1
    (torch.empty((3, 5), dtype=torch.int32, device="meta"), 2, TypeError),
    (torch.empty((3, 5), dtype=torch.bool, device="meta"), 2, TypeError),
    (torch.empty((2**31, 1), device="meta"), 1, ValueError),      # rows past int32
    (torch.empty((1, 2**31), device="meta"), 1, ValueError),      # columns past int32
    (torch.empty((3, 5), device="meta"), 2, ValueError),          # no kernel for the device
])
def test_wrapper_refuses_what_the_kernel_does_not_take(dists, k, err):
    before = tt.launches
    with pytest.raises(err):
        tt.smallest_k(dists, k)
    assert tt.launches == before
