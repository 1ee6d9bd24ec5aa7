"""tpu_ann_torch.utils.interrupt (twins of test_selectors_ivflib.py's
interrupt tests), its polls in k-means and in the HNSW graph's waves, and
k-means checkpoints that each package resumes from the other's file."""

import os
import pickle
import shutil

import numpy as np
import pytest

from tpu_ann.ops import kmeans as JK
from tpu_ann_torch import InterruptCallback, TimeoutGuard
from tpu_ann_torch.ops import hnsw as TH
from tpu_ann_torch.ops import kmeans as TK
from tpu_ann_torch.utils.interrupt import (
    FunctionInterrupt,
    InterruptError,
    TimeoutCallback,
)


def _tripping_after(n):
    calls = []

    def trip():
        calls.append(1)
        return len(calls) > n

    return calls, FunctionInterrupt(trip)


@pytest.fixture
def callback():
    """Sets the callback a test builds, and clears it whatever happens."""
    yield InterruptCallback.set
    InterruptCallback.clear()


def test_interrupt_kmeans(small_ds, callback):
    calls, cb = _tripping_after(2)
    callback(cb)
    with pytest.raises(InterruptError):
        TK.kmeans(small_ds.get_train(), 8,
                  TK.ClusteringParameters(niter=20, seed=0), device="cpu")
    assert len(calls) == 3            # one poll an iteration, the third trips


def test_timeout_guard_noop(small_ds):
    with TimeoutGuard(300.0):  # generous: must NOT trip
        assert isinstance(InterruptCallback.get(), TimeoutCallback)
        cent, _ = TK.kmeans(small_ds.get_train(), 8,
                            TK.ClusteringParameters(niter=3, seed=0),
                            device="cpu")
    assert cent.shape == (8, small_ds.d)
    assert InterruptCallback.get() is None


def test_timeout_guard_trips():
    with TimeoutGuard(0.0):
        assert InterruptCallback.is_interrupted()
        with pytest.raises(InterruptError):
            InterruptCallback.check()
    assert not InterruptCallback.is_interrupted()


def test_interrupt_during_graph_waves(callback):
    """build_graph polls before every wave (64, 128, 256, ... rows of a
    level's bucket) and extend_graph before each of its waves: a callback
    that trips at the third poll stops each mid-build."""
    rs = np.random.RandomState(0)
    x = rs.rand(1200, 16).astype(np.float32)
    calls, cb = _tripping_after(2)
    callback(cb)
    with pytest.raises(InterruptError):
        TH.build_graph(x, 8, 16, wave_size=128, device="cpu")
    assert len(calls) == 3
    InterruptCallback.clear()
    g = TH.build_graph(x[:600], 8, 16, wave_size=128, device="cpu")
    calls, cb = _tripping_after(2)
    callback(cb)
    with pytest.raises(InterruptError):
        TH.extend_graph(x, g, 600, m=8, ef_construction=16, wave_size=128)
    assert len(calls) == 3
    InterruptCallback.clear()
    g2 = TH.extend_graph(x, g, 600, m=8, ef_construction=16, wave_size=128)
    assert g2.neighbors0.shape[0] == 1200


def _rewind(path, it):
    with open(path, "rb") as f:
        st = pickle.load(f)
    assert set(st) == {"centroids", "iter", "key"} and st["key"] is None
    st["iter"] = it
    with open(path, "wb") as f:
        pickle.dump(st, f)


def _torch_kmeans(x, cp, ck):
    return TK.kmeans(x, 20, TK.ClusteringParameters(niter=cp[0], seed=cp[1]),
                     checkpoint=ck, device="cpu")


def _jax_kmeans(x, cp, ck):
    return JK.kmeans(x, 20, JK.ClusteringParameters(niter=cp[0], seed=cp[1]),
                     checkpoint=ck)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """One package writes the checkpoint of a 6-iteration run; it is
    rewound to iteration 2 (its centroids stay iteration 5's), and both
    packages resume from a copy of it: 3 iterations each, ending at the
    same centroids (the data needs no
    cluster split, so the random streams are not drawn; the two libraries
    sum in different orders, hence 1e-4)."""
    rs = np.random.RandomState(0)
    x = rs.rand(2000, 16).astype(np.float32)
    cp = (6, 3)
    ck = str(tmp_path / "km.pkl")
    first = _jax_kmeans if writer == "jax" else _torch_kmeans
    _, st_full = first(x, cp, ck)
    assert len(st_full) == 6 and not os.path.exists(ck + ".tmp")
    _rewind(ck, 2)
    shutil.copy(ck, ck + ".j")
    c_t, st_t = _torch_kmeans(x, cp, ck)
    c_j, st_j = _jax_kmeans(x, cp, ck + ".j")
    assert len(st_t) == len(st_j) == 3
    assert all(s.nsplit == 0 for s in st_t + st_j)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-4)
    with open(ck, "rb") as f:
        assert pickle.load(f)["iter"] == 5


def test_checkpoint_written_each_iteration(tmp_path, callback):
    """An interrupted run leaves the checkpoint of its last finished
    iteration; the next run resumes from it and ends where an
    uninterrupted run ends."""
    rs = np.random.RandomState(0)
    x = rs.rand(2000, 16).astype(np.float32)
    ck = str(tmp_path / "km.pkl")
    _, cb = _tripping_after(4)
    callback(cb)
    with pytest.raises(InterruptError):
        _torch_kmeans(x, (8, 0), ck)
    InterruptCallback.clear()
    with open(ck, "rb") as f:
        assert pickle.load(f)["iter"] == 3
    c2, st2 = _torch_kmeans(x, (8, 0), ck)
    assert len(st2) == 4
    c_ref, _ = _torch_kmeans(x, (8, 0), None)
    np.testing.assert_allclose(c2, c_ref, rtol=0, atol=1e-5)
