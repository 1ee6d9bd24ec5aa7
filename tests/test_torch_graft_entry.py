"""The entry points of tpu_ann_torch (tpu_ann_torch/graft_entry.py)
on the CPU, against the JAX package's __graft_entry__.py.

- entry(): the JAX step over its tiny index and the port's step over the
  same index carried across (utils.convert.ivf_flat_from_reference: the
  same centroids and lists) on the same queries: ids equal, distances
  within rtol 1e-5 (f32 sums in another order). The port's own entry on
  the CPU builds the same shapes, answers every query, and its step over
  a copy of its index moved through a serialized file is the same.
- dryrun_multichip(2) and (4) over gloo worlds of CPU processes finish
  within a 120 s deadline (every rank's results equal rank 0's), with no
  kernel launch on the CPU.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from tpu_ann_torch import graft_entry as G
from tpu_ann_torch.utils.convert import ivf_flat_from_reference
from tpu_ann_torch.utils.index_io import deserialize_index, serialize_index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_entry():
    spec = importlib.util.spec_from_file_location(
        "reference_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def test_entry_step_matches_reference():
    ref = _reference_entry()
    jfn, (jxq,) = ref.entry()
    D0, I0 = (np.asarray(a) for a in jfn(jxq))
    jidx = ref._build_tiny_index()
    tidx = ivf_flat_from_reference(_export(jidx), device="cpu")
    fn, (xq,) = G.entry(device="cpu", index=tidx)
    assert xq.device.type == "cpu" and xq.dtype == torch.float32
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    D1, I1 = (t.numpy() for t in fn(xq))
    assert D1.shape == I1.shape == (64, 10)
    np.testing.assert_array_equal(I1, I0)
    np.testing.assert_allclose(D1, D0, rtol=1e-5)


def test_entry_builds_its_own_index():
    fn, (xq,) = G.entry(device="cpu")
    assert fn.index.device.type == "cpu"
    assert (fn.index.d, fn.index.nlist, fn.index.ntotal) == (32, 16, 2048)
    D1, I1 = fn(xq)
    assert D1.shape == I1.shape == (64, 10)
    assert bool((I1 >= 0).all()) and bool((D1[:, 1:] >= D1[:, :-1]).all())
    copy = deserialize_index(serialize_index(fn.index), device="cpu")
    fn2, _ = G.entry(device="cpu", index=copy)
    D2, I2 = fn2(xq)
    assert torch.equal(D1, D2) and torch.equal(I1, I2)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    out = G.dryrun_multichip(n, device="cpu", timeout_s=120.0)
    assert (out["n_replicas"], out["n_shards"]) == (2, n // 2)
    assert out["backend"] == "gloo"
    assert out["k3_launches"] == out["k4_launches"] == 0
    assert f"dryrun_multichip({n}): ok" in capsys.readouterr().out
