"""The C handle of tpu_ann_torch (tpu_ann_torch/capi.py and its own
embedded-CPython library, tpu_ann_torch/c_api/) on the CPU.

(1) The library and its C example are built with cc into
    tpu_ann_torch/_build/ and the example runs as a subprocess (never in
    this process: the JAX package's library exports the same symbols) on
    TPU_ANN_TORCH_DEVICE=cpu: factory / train / add / search / io / params
    / reconstruct / remove / sa codec / range search / the error path /
    shutdown, and its "C API example: OK" line.
(2) tpu_ann_torch.capi called directly, through memoryviews as the C side
    passes them, against the JAX package's capi on the same inputs: an
    IVF16,Flat over integer data (d 16, 4000 rows from a numpy seed)
    trained and filled through the JAX capi, its centroids and lists
    carried across (utils.convert.ivf_flat_from_reference). Distances bit
    for bit, ids equal up to ties (exact scores on integer data in both
    packages); each package's write_index read by the other's read_index
    and searched alike.
(3) configure_device: without CUDA, asking for it (or for nothing, which
    means CUDA) raises; "cpu" is taken.
"""

import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest
import torch

from tpu_ann import capi as jcapi
from tpu_ann_torch import capi
from tpu_ann_torch.utils.convert import ivf_flat_from_reference
from torch_parity import assert_topk_equal

D, NB, NQ, K, NLIST = 16, 4000, 60, 10, 16
L2 = 1


def _embeddable() -> bool:
    cv = sysconfig.get_config_var
    return bool(cv("Py_ENABLE_SHARED")) and str(
        cv("LDLIBRARY") or "").endswith(".so")


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(1234)
    xb = rs.randint(0, 64, (NB, D)).astype(np.float32)
    xq = rs.randint(0, 64, (NQ, D)).astype(np.float32)
    return xb, xq


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv(capi.DEVICE_ENV, "cpu")
    monkeypatch.setattr(capi, "_device", [])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _search(mod, h, xq, k=K):
    Dv = np.zeros((len(xq), k), np.float32)
    Iv = np.zeros((len(xq), k), np.int64)
    mod.search(h, memoryview(xq), len(xq), xq.shape[1], k, memoryview(Dv),
               memoryview(Iv))
    return Dv, Iv


def _export(idx) -> dict:
    il = idx.invlists
    return {"d": idx.d, "metric": idx.metric_type, "nlist": idx.nlist,
            "ntotal": idx.ntotal,
            "vectors": np.asarray(idx.quantizer.vectors),
            "data": np.asarray(il.data), "ids": np.asarray(il.ids),
            "norms": np.asarray(il.norms),
            "list_block_start": np.asarray(il.list_block_start),
            "list_nblocks": np.asarray(il.list_nblocks),
            "ids_flat": np.asarray(idx._ids_flat)}


@pytest.fixture(scope="module")
def jax_handle(data):
    xb, _ = data
    h = jcapi.factory(D, f"IVF{NLIST},Flat", L2)
    jcapi._get(h).cp.niter = 4
    jcapi.train(h, memoryview(xb), NB, D)
    ids = (1000 + 3 * np.arange(NB)).astype(np.int64)
    jcapi.add_with_ids(h, memoryview(xb), NB, D, memoryview(ids))
    jcapi.set_parameter(h, "nprobe", 4)
    yield h
    jcapi.free(h)


@pytest.mark.skipif(shutil.which("cc") is None or not _embeddable(),
                    reason="no C compiler or no shared libpython")
def test_c_example_end_to_end(tmp_path):
    built = capi.build_library()
    assert os.path.dirname(built["library"]).startswith(capi.BUILD_DIR)
    assert capi.build_library() == built          # built once, then found
    run = subprocess.run([built["example"], str(tmp_path / "example.idx")],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=600, env=capi.example_env("cpu"))
    assert run.returncode == 0, run.stdout + run.stderr
    assert "backend: cpu" in run.stdout
    assert "C API example: OK" in run.stdout
    assert not os.path.exists(tmp_path / "example.idx")


@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_search_equals_reference_capi(data, jax_handle, nprobe):
    _, xq = data
    h = capi._new_handle(ivf_flat_from_reference(
        _export(jcapi._get(jax_handle)), device="cpu"))
    try:
        jcapi.set_parameter(jax_handle, "nprobe", nprobe)
        capi.set_parameter(h, "nprobe", nprobe)
        D0, I0 = _search(jcapi, jax_handle, xq)
        D1, I1 = _search(capi, h, xq)
        assert_topk_equal(D0, I0, D1, I1)
        assert I1.min() >= 1000                    # user ids, not rows
        for f in ("ntotal", "dim", "is_trained", "metric_type"):
            assert getattr(capi, f)(h) == getattr(jcapi, f)(jax_handle)
    finally:
        jcapi.set_parameter(jax_handle, "nprobe", 4)
        capi.free(h)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_cross_packages(data, jax_handle, tmp_path, writer):
    _, xq = data
    path = str(tmp_path / "ivf.idx")
    h = capi._new_handle(ivf_flat_from_reference(
        _export(jcapi._get(jax_handle)), device="cpu"))
    try:
        (capi.write_index(h, path) if writer == "port"
         else jcapi.write_index(jax_handle, path))
        ht, hj = capi.read_index(path, 1), jcapi.read_index(path, 0)
        for mod, hh in ((capi, ht), (jcapi, hj)):
            mod.set_parameter(hh, "nprobe", 4)
        D0, I0 = _search(jcapi, jax_handle, xq)
        for mod, hh in ((capi, ht), (jcapi, hj)):
            Dv, Iv = _search(mod, hh, xq)
            assert_topk_equal(D0, I0, Dv, Iv)
            assert mod.ntotal(hh) == NB
        capi.free(ht)
        jcapi.free(hj)
    finally:
        capi.free(h)


def test_port_handle_builds_and_edits(data):
    """The port's own factory / train / add / search, reconstruct,
    remove_ids, range search and sa codec through the handle functions."""
    xb, xq = data
    assert capi.configure_device() == "cpu"
    h = capi.factory(D, "IVF16,Flat", L2)
    assert capi.is_trained(h) == 0
    capi.train(h, memoryview(xb), NB, D)
    capi.add(h, memoryview(xb), NB, D)
    capi.set_parameter(h, "nprobe", NLIST)
    Dv, Iv = _search(capi, h, xq, 5)
    exact = ((xq[:, None, :] - xb[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(Dv[:, 0], exact.min(1))
    rec = np.zeros(D, np.float32)
    capi.reconstruct(h, 7, memoryview(rec))
    np.testing.assert_array_equal(rec, xb[7])
    rm = np.array([0, 1, 2], np.int64)
    assert capi.remove_ids(h, memoryview(rm), 3) == 3
    assert capi.ntotal(h) == NB - 3
    capi.free(h)
    with pytest.raises(ValueError, match="invalid or freed"):
        capi.ntotal(h)

    flat = capi.factory(D, "Flat", L2)
    capi.add(flat, memoryview(xb), NB, D)
    rh = capi.range_search(flat, memoryview(xq), NQ, D, 200.0)
    nnz = capi.range_result_nnz(rh)
    lims = np.zeros(NQ + 1, np.int64)
    rd, ri = np.zeros(nnz, np.float32), np.zeros(nnz, np.int64)
    capi.range_result_fetch(rh, NQ, memoryview(lims), memoryview(rd),
                            memoryview(ri))
    assert lims[-1] == nnz == int((exact < 200.0).sum())
    assert (rd < 200.0).all()
    capi.free(rh)

    pq = capi.factory(D, "PQ4x8", L2)
    capi.train(pq, memoryview(xb), NB, D)
    cs = capi.sa_code_size(pq)
    codes = np.zeros((NQ, cs), np.uint8)
    capi.sa_encode(pq, memoryview(xq), NQ, D, memoryview(codes))
    dec = np.zeros((NQ, D), np.float32)
    capi.sa_decode(pq, memoryview(codes), NQ, memoryview(dec))
    assert cs == 4
    assert ((dec - xq) ** 2).mean() < ((xq - xq.mean(0)) ** 2).mean()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device exists")
@pytest.mark.parametrize("asked", [None, "", "cuda", "cuda:0"])
def test_configure_device_refuses_missing_cuda(monkeypatch, asked):
    if asked is None:
        monkeypatch.delenv(capi.DEVICE_ENV, raising=False)
    else:
        monkeypatch.setenv(capi.DEVICE_ENV, asked)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capi.configure_device()
    assert capi._device == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capi.factory(D, "Flat", L2)
