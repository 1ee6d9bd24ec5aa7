"""The native host helpers of tpu_ann_torch (utils/native.py) on the CPU,
beside the JAX package's bindings of the same C++ source: the fbin / fvecs
readers, the counting-sort invlist scatter, row norms and reverse edges,
and the numpy fallbacks.

The port builds its own copy of native/tpu_ann_native.cpp under
tpu_ann_torch/_build; where the reference's library is built too, the two
are compared. Tolerances: every output is bit-equal to the numpy
path and to the reference's (the same C++ code and numpy code), except the
norms, within rtol 1e-5 of an f64 sum."""

import os

import numpy as np
import pytest

from tpu_ann.utils import native as JN
from tpu_ann_torch.ops import ivf_scan as TS
from tpu_ann_torch.utils import native
from tpu_ann_torch.utils.datasets import fvecs_write, write_fbin


@pytest.fixture(autouse=True)
def _needs_library():
    # checked when a test runs, not at collection: the check builds it
    if not native.HAVE_NATIVE:
        pytest.skip("native library not built (no g++)")


@pytest.fixture
def no_native(monkeypatch):
    """The numpy fallbacks: the library as if it could not be built."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)


def test_library_is_built_in_the_package():
    so = native.library_path()
    assert os.path.exists(so)
    assert os.path.dirname(so) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    cxx, cflags, ldflags = native.make_flags()
    assert "-O3" in cflags and "-fPIC" in cflags and "-shared" in ldflags


def test_disable_variable(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("TPU_ANN_DISABLE_NATIVE", "1")
    assert native.HAVE_NATIVE is False
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.delenv("TPU_ANN_DISABLE_NATIVE")
    assert native.HAVE_NATIVE is True


def test_fbin_and_fvecs(tmp_path, request):
    rs = np.random.RandomState(1)
    x = rs.rand(500, 12).astype(np.float32)
    p = str(tmp_path / "x.fbin")
    write_fbin(p, x)
    np.testing.assert_array_equal(native.read_fbin_native(p), x)
    np.testing.assert_array_equal(native.read_fbin_native(p, 100, 50),
                                  x[100:150])
    if JN.HAVE_NATIVE:
        np.testing.assert_array_equal(native.read_fbin_native(p, 100, 50),
                                      JN.read_fbin_native(p, 100, 50))
    f = str(tmp_path / "x.fvecs")
    fvecs_write(f, x[:300])
    np.testing.assert_array_equal(native.read_fvecs_native(f), x[:300])
    np.testing.assert_array_equal(native.read_fvecs_native(f, 100), x[:100])
    request.getfixturevalue("no_native")
    np.testing.assert_array_equal(native.read_fbin_native(p, 7, 9), x[7:16])
    np.testing.assert_array_equal(native.read_fvecs_native(f, 20), x[:20])
    with pytest.raises(IOError):
        native.read_fvecs_native(str(tmp_path / "absent.fvecs"))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pack_rows(dtype):
    """The native scatter gives the packed layout of the port's numpy
    packer (pack_invlists, on the CPU) and of the reference's native
    binding."""
    rs = np.random.RandomState(2)
    n, nlist, B = 2000, 32, 8
    x = (rs.rand(n, 16) * 255).astype(dtype)
    ids = (np.arange(n) * 3 + 1).astype(np.int32)
    assign = rs.randint(nlist, size=n).astype(np.int64)
    assign[assign == 5] = 6                   # an empty list
    data, nids, starts, nblocks = native.pack_rows_native(x, ids, assign,
                                                          nlist, B)
    assert data.dtype == dtype and nblocks[5] == 0
    if JN.HAVE_NATIVE:
        for a, b in zip((data, nids, starts, nblocks),
                        JN.pack_rows_native(x, ids, assign, nlist, B)):
            np.testing.assert_array_equal(a, b)
    if dtype == np.float32:
        pil = TS.pack_invlists(x, ids, assign, nlist, block_size=B,
                               device="cpu")
        np.testing.assert_array_equal(pil.data.numpy(), data)
        np.testing.assert_array_equal(pil.ids.numpy(), nids)
        np.testing.assert_array_equal(pil.list_block_start.numpy(),
                                      starts.astype(np.int32))
        np.testing.assert_array_equal(pil.list_nblocks.numpy(),
                                      nblocks.astype(np.int32))
    keys = nids.reshape(-1)
    got = data.reshape(-1, 16)[keys >= 0]
    np.testing.assert_array_equal(got[np.argsort(keys[keys >= 0])], x)
    with pytest.raises(ValueError):
        native.pack_rows_native(x, ids, np.full(n, nlist), nlist, B)


def test_pack_rows_fallback(no_native):
    assert native.pack_rows_native(np.zeros((4, 2), np.float32),
                                   np.arange(4), np.zeros(4), 2, 8) is None
    assert native.reverse_edges_native(np.zeros((3, 2), np.int32),
                                       np.zeros((3, 2), np.float32), 2) \
        is None


def test_norms(request):
    x = np.random.RandomState(3).rand(1000, 33).astype(np.float32)
    ref = (x.astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(native.norms_l2sqr_native(x), ref, rtol=1e-5)
    if JN.HAVE_NATIVE:
        np.testing.assert_array_equal(native.norms_l2sqr_native(x),
                                      JN.norms_l2sqr_native(x))
    request.getfixturevalue("no_native")
    np.testing.assert_allclose(native.norms_l2sqr_native(x), ref, rtol=1e-6)


def test_reverse_edges():
    """The counting-scatter reverse edges equal the reference's and the
    numpy stable-sort construction."""
    r = np.random.RandomState(3)
    n, m, cap = 2000, 6, 4
    fwd = r.randint(-1, n, size=(n, m)).astype(np.int32)
    fd = r.rand(n, m).astype(np.float32)
    nat_i, nat_d = native.reverse_edges_native(fwd, fd, cap)
    if JN.HAVE_NATIVE:
        for a, b in zip((nat_i, nat_d),
                        JN.reverse_edges_native(fwd, fd, cap)):
            np.testing.assert_array_equal(a, b)
    src = np.repeat(np.arange(n, dtype=np.int32), m)
    dst, dd = fwd.reshape(-1), fd.reshape(-1)
    ok = dst >= 0
    src, dst, dd = src[ok], dst[ok], dd[ok]
    order = np.argsort(dst, kind="stable")
    src, dst, dd = src[order], dst[order], dd[order]
    pos = np.arange(len(dst)) - np.searchsorted(dst, dst)
    keep = pos < cap
    ref_i = np.full((n, cap), -1, np.int32)
    ref_d = np.full((n, cap), np.inf, np.float32)
    ref_i[dst[keep], pos[keep]] = src[keep]
    ref_d[dst[keep], pos[keep]] = dd[keep]
    np.testing.assert_array_equal(nat_i, ref_i)
    np.testing.assert_array_equal(nat_d, ref_d)
