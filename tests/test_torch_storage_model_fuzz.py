"""Twin of tests/test_storage_model_fuzz.py for the port's storage engines.

The storage classes run no threads, so one op sequence (the JAX test's own
generator, ``_step``, on its seeds) drives both packages' engines at once
through ``Both``: every call goes to the JAX engine and to the port's, and
the two must return equal results.  Beside the JAX test's model checks,
after each flush every posting's entries are equal in both packages
(ids, vectors and versions, with and without the deleted entries, so the
deleted flags too) and the port's WAL is byte for byte the JAX package's.
The crash-point replays, the torn WAL header and the crash at every
namespace op of ``compact()`` run on the port's files."""

import os
import shutil
import types

import numpy as np
import pytest

import spfresh_tpu.lire.packed_storage as JPS
import spfresh_tpu_torch.lire.packed_storage as PS
from spfresh_tpu.lire import LireStorage as JLireStorage
from spfresh_tpu_torch.lire import LireStorage
from test_storage_model_fuzz import (
    DIM,
    Model,
    _assert_agree,
    _mk_packed,
    _rand_vec,
    _seed_model_from,
    _step,
)


def _same(a, b, ctx):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), ctx
        for x, y in zip(a, b):
            _same(x, y, ctx)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=ctx)
    else:
        assert a == b, f"{ctx}: {a!r} != {b!r}"


class Both:
    """Forwards each method call to the JAX engine and to the port's and
    asserts equal results (or exceptions of the same class name); returns
    the JAX engine's."""

    def __init__(self, j, p):
        self.j, self.p = j, p

    def __getattr__(self, name):
        fj, fp = getattr(self.j, name), getattr(self.p, name)

        def call(*a, **kw):
            try:
                rj = fj(*a, **kw)
            except Exception as ej:
                with pytest.raises(Exception) as ep:
                    fp(*a, **kw)
                assert type(ep.value).__name__ == type(ej).__name__, (name, ej, ep.value)
                raise
            rp = fp(*a, **kw)
            _same(rj, rp, f"{name}{a}")
            return rj

        return call


def _contents(st):
    """pid -> (live (ids, vecs, versions), all entries incl. deleted)."""
    return {p: (st.get_posting(p), st.get_posting(p, include_deleted=True))
            for p in sorted(st.posting_ids())}


def _assert_engines_equal(both, ctx):
    a, b = _contents(both.j), _contents(both.p)
    assert list(a) == list(b), ctx
    for p in a:
        _same(a[p], b[p], f"{ctx}: posting {p}")
        assert both.j.get_posting_version(p) == both.p.get_posting_version(p), ctx
        np.testing.assert_array_equal(both.p.get_posting_centroid(p),
                                      both.j.get_posting_centroid(p), err_msg=ctx)


def _state(st):
    return {p: sorted((int(v), tuple(np.round(np.asarray(x, np.float32), 5)))
                      for v, x in zip(*st.get_posting(p)[:2]))
            for p in st.posting_ids()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_storage_model_fuzz(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    jpath = _mk_packed(tmp_path, rng)
    path = str(tmp_path / "port_idx")
    shutil.copytree(jpath, path)
    st = Both(JPS.PackedLireStorage(jpath), PS.PackedLireStorage(path))
    m = _seed_model_from(st)
    next_vid, next_pid = 100_000, st.allocate_posting_id()
    snapshots = []
    wal, jwal = os.path.join(path, "overlay.wal"), os.path.join(jpath, "overlay.wal")
    for step in range(120):
        next_vid, next_pid = _step(st, m, rng, next_vid, next_pid, True)
        st.flush()
        _assert_engines_equal(st, f"seed {seed} step {step}")
        assert os.path.exists(wal) == os.path.exists(jwal)
        if os.path.exists(wal):
            with open(wal, "rb") as f, open(jwal, "rb") as g:
                assert f.read() == g.read(), f"seed {seed} step {step}: WAL bytes differ"
        snapshots.append((os.path.getsize(wal) if os.path.exists(wal) else 0,
                          m.clone_state()))
        if step % 10 == 9:
            _assert_agree(st, m, f"seed {seed} step {step}")
        if step % 40 == 39:
            st.close()
            st = Both(JPS.PackedLireStorage(jpath), PS.PackedLireStorage(path))
            _assert_agree(st, m, f"seed {seed} reopen@{step}")
            _assert_engines_equal(st, f"seed {seed} reopen@{step}")
        if step == 60:
            st.compact()
            _assert_agree(st, m, f"seed {seed} post-compact")
            _assert_engines_equal(st, f"seed {seed} post-compact")
            snapshots = []
    st.close()

    # The port's WAL truncated at op boundaries reopens in the port to the
    # model's state there; torn mid-record tails reopen without raising.
    assert snapshots and os.path.exists(wal)
    crash_dir = str(tmp_path / "crash")
    for pick in [0, len(snapshots) // 2, len(snapshots) - 1]:
        size, want = snapshots[pick]
        shutil.rmtree(crash_dir, ignore_errors=True)
        shutil.copytree(path, crash_dir)
        with open(os.path.join(crash_dir, "overlay.wal"), "r+b") as f:
            f.truncate(size)
        st2 = PS.PackedLireStorage(crash_dir)
        assert _state(st2) == want, f"seed {seed} crash@{pick}"
        st2.close()
    size_full = os.path.getsize(wal)
    for cut in [size_full - 3, size_full - 17]:
        if cut <= snapshots[0][0]:
            continue
        shutil.rmtree(crash_dir, ignore_errors=True)
        shutil.copytree(path, crash_dir)
        with open(os.path.join(crash_dir, "overlay.wal"), "r+b") as f:
            f.truncate(cut)
        jcrash = crash_dir + "_jax"
        shutil.rmtree(jcrash, ignore_errors=True)
        shutil.copytree(crash_dir, jcrash)
        st2 = PS.PackedLireStorage(crash_dir)  # must not raise
        assert [w for s, w in snapshots if s <= cut], f"seed {seed} torn@{cut}: no boundary"
        # A torn tail may keep a prefix of the last op's records; whatever
        # it keeps, the JAX package replays the same torn WAL alike.
        jst = JPS.PackedLireStorage(jcrash)
        assert _state(st2) == _state(jst), f"seed {seed} torn@{cut}"
        st2.close()
        jst.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_ram_storage_model_fuzz(tmp_path, seed):
    rng = np.random.default_rng(2000 + seed)
    jdir, pdir = str(tmp_path / "jram"), str(tmp_path / "ram")
    st = Both(JLireStorage(jdir, DIM), LireStorage(pdir, DIM))
    m = Model()
    next_vid, next_pid = 100_000, 10_000
    for pid in range(4):
        vs = [_rand_vec(rng) for _ in range(4)]
        cent = _rand_vec(rng)
        st.import_posting(pid, list(range(next_vid, next_vid + 4)), np.stack(vs), cent)
        m.postings[pid] = [(next_vid + j, v) for j, v in enumerate(vs)]
        m.cents[pid] = cent
        next_vid += 4
    for step in range(100):
        next_vid, next_pid = _step(st, m, rng, next_vid, next_pid, False)
        st.flush()
        _assert_engines_equal(st, f"ram seed {seed} step {step}")
        if step % 10 == 9:
            _assert_agree(st, m, f"ram seed {seed} step {step}")
        if step % 45 == 44:  # reopen: per-posting log replay, in both packages
            st = Both(JLireStorage(jdir, DIM), LireStorage(pdir, DIM))
            _assert_agree(st, m, f"ram seed {seed} reopen@{step}")
            _assert_engines_equal(st, f"ram seed {seed} reopen@{step}")
    _assert_agree(st, m, f"ram seed {seed} final")
    # Each package's files reopen in the other with the same contents.
    _assert_engines_equal(Both(JLireStorage(pdir, DIM), LireStorage(jdir, DIM)),
                          f"ram seed {seed} crossed")


def test_ram_wal_torn_header_reopens_empty(tmp_path):
    """A wal.log torn inside its 12-byte header, written by either package,
    reopens in the port as if no WAL existed; the dead file is removed and
    the next append writes a well-formed WAL."""
    for writer, name in ((JLireStorage, "j"), (LireStorage, "p")):
        rng = np.random.default_rng(0)
        src = str(tmp_path / f"ram_{name}")
        st = writer(src, DIM)
        for pid in range(2):
            for j in range(3):
                st.store_vector(pid, pid * 10 + j, rng.standard_normal(DIM).astype(np.float32))
        for cut_to in (0, 3, 11):
            crash = str(tmp_path / f"crash_{name}{cut_to}")
            shutil.copytree(src, crash)
            with open(os.path.join(crash, "wal.log"), "r+b") as f:
                f.truncate(cut_to)
            st2 = LireStorage(crash, DIM)  # must not raise
            assert sum(st2.get_vector_count(p) for p in st2.posting_ids()) == 0
            assert not os.path.exists(os.path.join(crash, "wal.log"))
            st2.store_vector(0, 999, rng.standard_normal(DIM).astype(np.float32))
            assert 999 in LireStorage(crash, DIM).get_posting(0)[0]
            assert 999 in JLireStorage(crash, DIM).get_posting(0)[0]


def _crashing_os(real, calls, crash_at):
    """A stand-in for a module's ``os`` whose ``replace`` and ``remove``
    count their calls and raise at call ``crash_at`` (0: never)."""

    def counted(fn):
        def wrapper(*a, **k):
            calls.append(fn.__name__)
            if len(calls) == crash_at:
                raise OSError("simulated crash")
            return fn(*a, **k)

        return wrapper

    ns = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real) if not k.startswith("__")})
    ns.replace, ns.remove = counted(real.replace), counted(real.remove)
    return ns


def _compact_store(tmp_path, name):
    rng = np.random.default_rng(7)
    path = _mk_packed(tmp_path / name, rng, n=80)
    st = PS.PackedLireStorage(path)
    pids = st.posting_ids()
    for j in range(6):
        st.store_vector(int(pids[j % len(pids)]), 900 + j, _rand_vec(rng))
    st.mark_deleted(int(pids[0]), 900)
    st.flush()
    return path, st, rng


def test_compact_makes_the_jax_packages_namespace_ops(tmp_path, monkeypatch):
    """The port's compact() renames and removes the same files in the same
    order as the JAX package's, so the crash test below covers each."""
    ops = {}
    for name, mod in (("jax", JPS), ("port", PS)):
        path, st, _ = _compact_store(tmp_path, name)
        st.close()
        st = mod.PackedLireStorage(path)
        calls = []
        monkeypatch.setattr(mod, "os", _crashing_os(os, calls, 0))
        st.compact()
        monkeypatch.setattr(mod, "os", os)
        ops[name] = calls
        st.close()
    assert ops["port"] == ops["jax"] and len(ops["port"]) == 6, ops


@pytest.mark.parametrize("crash_at", [1, 2, 3, 4, 5, 6])
def test_packed_compact_crash_at_every_namespace_op(tmp_path, monkeypatch, crash_at):
    """A crash at each namespace op of the port's compact() (the journal
    rename, the three file swaps, the WAL unlink, the journal unlink):
    reopening in the port, or in the JAX package, recovers exactly the
    pre-compact live state, and the store then takes a write and compacts
    cleanly."""
    path, st, rng = _compact_store(tmp_path, "idx")
    want = {p: sorted(map(int, st.get_posting(p)[0])) for p in st.posting_ids()}
    calls = []
    monkeypatch.setattr(PS, "os", _crashing_os(os, calls, crash_at))
    with pytest.raises(OSError, match="simulated crash"):
        st.compact()
    monkeypatch.setattr(PS, "os", os)
    st.close()
    assert len(calls) == crash_at

    jcopy = str(tmp_path / "jax_copy")
    shutil.copytree(path, jcopy)
    for opener, where in ((PS.PackedLireStorage, path), (JPS.PackedLireStorage, jcopy)):
        st2 = opener(where)  # recovery rolls forward or discards
        got = {p: sorted(map(int, st2.get_posting(p)[0])) for p in st2.posting_ids()}
        assert got == want, f"crash at namespace op {crash_at} lost state ({opener.__module__})"
        st2.close()
    st2 = PS.PackedLireStorage(path)
    st2.store_vector(int(st2.posting_ids()[0]), 990, _rand_vec(rng))
    st2.compact()
    assert 990 in st2.get_posting(int(st2.posting_ids()[0]))[0]
    st2.close()
    assert 990 in PS.PackedLireStorage(path).get_posting(int(st2.posting_ids()[0]))[0]
