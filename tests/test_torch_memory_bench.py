"""Memory and energy accounting of tpu_ann_torch (utils/memory.py) on the
CPU, beside the JAX package's: host RSS, device_memory_stats without CUDA,
index_memory_bytes over the tensors an index really holds, the
phase-marked MemoryMonitor and the RAPL EnergyMonitor.

Data: d 32, 4000 rows from a numpy seed, IVF of 16 lists. Tolerances:
index_memory_bytes is exact (each key the bytes of its tensors' storages,
``total`` their sum, equal to the bytes of every tensor the index holds on
its device); the reference's keys are present where the port holds the
same tensor, with the same bytes for the quantizer's centroids."""

import time

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from tpu_ann.models.ivf_hnsw import IndexIVFHNSW as JIVFHNSW
from tpu_ann.utils import memory as JM
from tpu_ann_torch.utils import memory as TM

D = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(9)
    return rs.randn(4000, D).astype(np.float32)


def test_host_rss():
    assert TM.host_rss_bytes() > 10 * 2**20


def test_device_memory_stats_without_cuda():
    """No CUDA: {} on a plain check (no catch-all: a CUDA error would
    raise)."""
    if torch.cuda.is_available():
        pytest.skip("checks the case without CUDA")
    assert TM.device_memory_stats() == {}
    assert TM.device_memory_stats("cuda:0") == {}


def _device_tensor_bytes(obj, dev, seen=None, depth=0):
    """Bytes of the storages of every tensor reachable from obj."""
    seen = set() if seen is None else seen
    if depth > 6:
        return 0
    total = 0
    if isinstance(obj, torch.Tensor):
        p = obj.untyped_storage().data_ptr()
        if obj.device == dev and obj.numel() and p not in seen:
            seen.add(p)
            total += obj.untyped_storage().nbytes()
        return total
    if isinstance(obj, (list, tuple)):
        items = list(obj)
    elif isinstance(obj, dict):
        items = list(obj.values())
    elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(
            "tpu_ann_torch"):
        items = list(vars(obj).values())
    else:
        return 0
    for v in items:
        total += _device_tensor_bytes(v, dev, seen, depth + 1)
    return total


def test_index_memory_accounting_ivf(data):
    """IVF-Flat: the reference's keys, the bf16 twin under its own key,
    total = the sum of the keys = every tensor the index holds."""
    idx = T.make_ivf_flat(D, 16, device="cpu")
    idx.cp.niter = 4
    idx.train(data)
    idx.add(data)
    idx.search(data[:5], 3)
    mem = TM.index_memory_bytes(idx)
    il = idx.invlists
    assert mem["invlist_codes"] == il.data.numel() * 4 >= 4000 * D * 4
    assert mem["invlist_bf16"] == il.data_bf16.numel() * 2
    assert mem["invlist_ids"] == il.ids.numel() * 4
    assert mem["invlist_norms"] == il.norms.numel() * 4
    assert mem["centroids"] == 16 * D * 4
    assert mem["total"] == sum(v for k, v in mem.items() if k != "total")
    assert mem["total"] == _device_tensor_bytes(idx, idx.device)


def test_index_memory_accounting_ivf_hnsw(data):
    """IndexIVFHNSW: the quantizer's graph under quantizer_graph, as the
    reference counts it."""
    idx = T.IndexIVFHNSW(D, 16, M=8, device="cpu")
    idx.cp.niter = 4
    idx.train(data[:2000])
    idx.add(data)
    mem = TM.index_memory_bytes(idx)
    assert mem["invlist_codes"] > 4000 * D * 4 * 0.9
    assert mem["quantizer_graph"] > 0
    assert mem["total"] == sum(v for k, v in mem.items() if k != "total")
    assert mem["total"] == _device_tensor_bytes(idx, idx.device)
    j = JIVFHNSW(D, nlist=16, M=8)
    j.cp.niter = 4
    j.train(data[:2000])
    j.add(data)
    jm = JM.index_memory_bytes(j)
    assert mem["centroids"] == jm["centroids"]
    assert {"invlist_codes", "invlist_ids", "invlist_norms", "centroids",
            "quantizer_graph"} <= set(jm) & set(mem)


def test_index_memory_accounting_flat_and_pq(data):
    flat = T.IndexFlat(D, device="cpu")
    flat.add(data)
    mem = TM.index_memory_bytes(flat)
    assert mem["vectors"] == 4000 * D * 4 and mem["norms"] == 4000 * 4
    assert mem["total"] == _device_tensor_bytes(flat, flat.device)
    pq = T.IndexIVFPQ(T.IndexFlat(D, device="cpu"), D, 16, 8, 8,
                      device="cpu")
    pq.cp.niter = 4
    pq.train(data)
    pq.add(data)
    pq.search(data[:4], 3)
    mem = TM.index_memory_bytes(pq)
    assert mem["total"] == _device_tensor_bytes(pq, pq.device)
    assert mem["total"] == sum(v for k, v in mem.items() if k != "total")
    if pq._decoded is not None:
        assert mem["decoded_cache_codes"] > 0


def test_memory_monitor_phases():
    with TM.MemoryMonitor(interval_s=0.05) as mon:
        mon.set_phase("alloc")
        x = np.ones((1000, 1000))
        time.sleep(0.06)
        mon.set_phase("free")
        del x
    assert mon.peak_rss() > 0
    assert mon.peak_hbm() == 0 or torch.cuda.is_available()
    rep = mon.report()
    assert "alloc" in rep and "free" in rep and "peak RSS" in rep
    assert {s.phase for s in mon.samples} >= {"alloc", "free"}


def test_energy_monitor_graceful():
    """joules / watts where RAPL is readable, None where it is not (as
    the reference's)."""
    with TM.EnergyMonitor() as em:
        time.sleep(0.05)
    assert em.seconds >= 0.05
    assert TM.rapl_available() == JM.rapl_available()
    if TM.rapl_available():
        assert em.joules is not None and em.joules >= 0
    else:
        assert em.joules is None and em.watts is None
        assert em.qps_per_watt(100) is None


def test_parse_config(tmp_path):
    """The benchmark grid's config parser (utils.benchmark), as in the
    reference's test file."""
    from tpu_ann.utils.benchmark import parse_config as jparse
    from tpu_ann_torch.utils.benchmark import parse_config

    p = tmp_path / "b.config"
    p.write_text("# comment\n[build]\nnlist = 1024, 4096\n[search]\n"
                 "nprobe_ratio = 0.01\nk = 10\n")
    cfg = parse_config(str(p))
    assert cfg == jparse(str(p))
    assert cfg["build"]["nlist"] == [1024.0, 4096.0]
