"""The IVF search's host <-> device copies through page-locked memory, on
the card: IVF-Flat (user ids, so the map to ids runs) and IVFHNSW (row
ids), at k 10 and k 100 (the kp <= 32 and kp >= 65 kernels). Without a
CUDA device these tests skip.

Run on a GPU machine (no jax needed, hence --noconftest):
    python -m pytest --noconftest -q tests/test_torch_cuda_pinned_io.py
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import tpu_ann_torch as T

pytestmark = pytest.mark.cuda

N, NQ, D, NPROBE = 20000, 1000, 128, 8
KINDS = ("ivf_flat", "ivf_hnsw")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _build(kind, dev):
    rs = np.random.RandomState(7)
    xb = rs.randint(0, 64, (N, D)).astype(np.float32)
    if kind == "ivf_flat":
        index = T.make_ivf_flat(D, 64, device=dev)
    else:
        index = T.IndexIVFHNSW(D, 256, M=16, device=dev)
    index.cp.niter = 4
    index.train(xb)
    if kind == "ivf_flat":
        index.add_with_ids(xb, 1000 + 3 * np.arange(N, dtype=np.int64))
    else:
        index.add(xb)
    index.nprobe = NPROBE
    return index


@pytest.fixture(scope="module")
def indexes():
    dev = _cuda()
    return {kind: _build(kind, dev) for kind in KINDS}


def _queries(seed, nq=NQ):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 64, (nq, D)).astype(np.float32)


cases = pytest.mark.parametrize("kind,k", [(kind, k) for kind in KINDS
                                           for k in (10, 100)])


@cases
def test_search_equals_the_device_results_copied_plainly(indexes, kind, k):
    index = indexes[kind]
    xq = _queries(1)
    Dh, Ih = index.search(xq, k)
    Dv, Iv = index.search_device(torch.from_numpy(xq).cuda(), k)
    np.testing.assert_array_equal(Dh, Dv.cpu().numpy())
    np.testing.assert_array_equal(Ih, index._map_ids(Iv.cpu().numpy()))
    assert Dh.shape == Ih.shape == (NQ, k)
    assert Dh.dtype == np.float32 and Ih.dtype == np.int64
    assert Dh.base is not None and Dh.base.is_pinned()


@cases
def test_results_are_writable_and_not_shared_by_a_later_call(indexes,
                                                             kind, k):
    """A result held across later calls keeps its values: each call takes
    blocks of its own from the cache, and a held array keeps its block."""
    index = indexes[kind]
    D1, I1 = index.search(_queries(2), k)
    keep = D1.copy(), I1.copy()
    later = [index.search(_queries(3 + i), k) for i in range(3)]
    np.testing.assert_array_equal(D1, keep[0])
    np.testing.assert_array_equal(I1, keep[1])
    for D2, I2 in later:
        assert not np.shares_memory(D1, D2)
        assert not np.shares_memory(I1, I2)
    assert D1.flags.writeable and I1.flags.writeable
    D1[0, 0], I1[0, 0] = -1.0, -7
    assert D1[0, 0] == -1.0 and I1[0, 0] == -7
    np.testing.assert_array_equal(later[0][0], index.search(_queries(3), k)[0])


@cases
def test_pinned_bytes_counts_both_copies(indexes, kind, k):
    index = indexes[kind]
    xq = _queries(4)
    Dh, Ih, st = index.search_stats(xq, k)
    assert st.pinned_bytes == NQ * D * 4 + NQ * k * (4 + 8)
    np.testing.assert_array_equal(Dh, index.search(xq, k)[0])
    # a tensor on the device goes up as it is: only the copy out counts
    _, _, st = index.search_stats(torch.from_numpy(xq).cuda(), k)
    assert st.pinned_bytes == NQ * k * (4 + 8)


@cases
def test_a_read_only_input_is_uploaded_whole(indexes, kind, k):
    index = indexes[kind]
    xq = _queries(5)
    ro = xq.copy()
    ro.flags.writeable = False
    D0, I0 = index.search(xq, k)
    D1, I1 = index.search(ro, k)
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)


@pytest.mark.parametrize("kind", KINDS)
def test_no_pageable_copy_in_a_search(indexes, kind):
    """Under the profiler every copy of a search, the chunked form too,
    reads or writes page-locked memory; an empty batch answers (0, k)."""
    index = indexes[kind]
    xq = _queries(6)
    index.search(xq, 10)
    index.search_chunk = 300
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            D0, _ = index.search(xq, 10)
            torch.cuda.synchronize()
    finally:
        index.search_chunk = 0
    copies = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA and "Memcpy" in e.name]
    assert copies and not [c for c in copies if "Pageable" in c], copies
    np.testing.assert_array_equal(D0, index.search(xq, 10)[0])
    De, Ie = index.search(xq[:0], 10)
    assert De.shape == Ie.shape == (0, 10)
