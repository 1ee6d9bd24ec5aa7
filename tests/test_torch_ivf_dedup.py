"""IndexIVFFlatDedup of tpu_ann_torch against the JAX package's, on the
CPU: duplicates kept in ``instances`` and expanded into the results,
promotion of a surviving duplicate on removal, the faiss-parity refusals,
the IwFD index file read by the other package and the carry-over of a JAX
index's arrays."""

import numpy as np
import pytest

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import IndexIVFFlatDedup as JDedup
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.selectors import IDSelectorBatch as JBatch
from tpu_ann.utils import index_io as jio
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import IndexIVFFlatDedup as TDedup
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.models.selectors import IDSelectorBatch as TBatch
from tpu_ann_torch.utils import index_io as tio
from tpu_ann_torch.utils.convert import ivf_flat_from_reference

D, NLIST, K = 16, 8, 10


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(41)
    base = rs.randint(0, 20, size=(1500, D)).astype(np.float32)
    # every 5th row repeats an earlier one, some rows three times
    dup_of = rs.randint(0, 1000, 500)
    xb = np.concatenate([base[:1000], base[dup_of]])
    xq = np.concatenate([base[dup_of[:20]],
                         rs.randint(0, 20, size=(20, D)).astype(np.float32)])
    cent = base[rs.choice(1000, NLIST, replace=False)]
    return xb, xq, cent


def _pair(data):
    xb, _, cent = data
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            q = JFlat(D)
            q.add(cent)
            idx = JDedup(q, D, NLIST)
            # the reference's per-list cap is a TPU-watchdog workaround
            # that the port does not copy: read whole lists on both sides
            idx.max_list_scan_factor = 0
        else:
            q = TFlat(D, device="cpu")
            q.add(cent)
            idx = TDedup(q, D, NLIST, device="cpu")
        idx.quantizer_trains_alone = 1
        idx.train(xb)
        idx.add_with_ids(xb[:1200], 10 + np.arange(1200, dtype=np.int64))
        idx.add_with_ids(xb[1200:], 10 + np.arange(1200, 1500,
                                                   dtype=np.int64))
        idx.nprobe = 3
        out.append(idx)
    return out


def _equal(j, t, xq):
    """Same instances and the same expanded results (the expansion keeps
    the base order, and integer data makes every score exact)."""
    assert t.instances == j.instances
    assert t.ntotal == j.ntotal
    D0, I0 = j.search(xq, K, params=JParams(nprobe=3))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=3))
    np.testing.assert_array_equal(D1, D0)
    # within a run of equal distances the base results may tie
    for r in range(len(xq)):
        for dist in np.unique(D0[r]):
            a, b = I0[r][D0[r] == dist], I1[r][D1[r] == dist]
            if dist != D0[r][-1]:
                assert sorted(a) == sorted(b)
    return D1, I1


def test_dedup_add_and_search_expansion(data):
    xb, xq, _ = data
    j, t = _pair(data)
    assert t.instances and t.ntotal < len(xb)
    D1, I1 = _equal(j, t, xq)
    # a query equal to a duplicated row gets the row and its duplicates
    # at distance 0
    rep = next(iter(t.instances))
    row = xb[rep - 10]
    Dq, Iq = t.search(row[None], K)
    zero = set(Iq[0][Dq[0] == 0])
    assert {rep, *t.instances[rep]} <= zero


def test_dedup_remove_promotes_a_duplicate(data):
    xb, xq, _ = data
    j, t = _pair(data)
    keys = list(t.instances)
    reps = keys[:30]                           # stored rows with duplicates
    dups = [t.instances[r][-1] for r in keys[30:40]]
    heirs = [t.instances[r][0] for r in reps]
    gone = np.asarray(reps + dups + [11, 12, 13], np.int64)
    assert t.remove_ids(TBatch(gone)) == j.remove_ids(JBatch(gone))
    _equal(j, t, xq)
    assert not set(reps) & set(t.instances)
    # each removed representative's row lives on under its first duplicate
    stored = set(np.concatenate(t._ids_host).tolist())
    assert set(heirs) <= stored and not set(reps) & stored
    with pytest.raises(RuntimeError):
        t.update_vectors([20], xb[:1])
    with pytest.raises(RuntimeError):
        t.range_search(xq, 1.0)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_iwfd_file_round_trips_across_packages(data, tmp_path, writer):
    _, xq, _ = data
    j, t = _pair(data)
    path = str(tmp_path / "dedup.idx")
    if writer == "jax":
        jio.write_index(j, path)
        other = tio.read_index(path, device="cpu")
        assert isinstance(other, TDedup)
        _equal(j, other, xq)
    else:
        tio.write_index(t, path)
        other = jio.read_index(path)
        assert isinstance(other, JDedup)
        _equal(other, t, xq)


def test_dedup_from_reference(data):
    _, xq, _ = data
    j, _ = _pair(data)
    il = j.invlists
    state = {"d": j.d, "metric": j.metric_type, "nlist": j.nlist,
             "ntotal": j.ntotal, "vectors": np.asarray(j.quantizer.vectors),
             "data": np.asarray(il.data), "ids": np.asarray(il.ids),
             "norms": np.asarray(il.norms),
             "list_block_start": np.asarray(il.list_block_start),
             "list_nblocks": np.asarray(il.list_nblocks),
             "ids_flat": np.asarray(j._ids_flat),
             "instances": j.instances}
    t = ivf_flat_from_reference(state, device="cpu")
    assert isinstance(t, TDedup)
    t.nprobe = 3
    _equal(j, t, xq)


def test_dedup_remove_count_equals_stored_ids_gone(data):
    """remove_ids counts each stored id that goes once: a representative
    removed with all its duplicates is the base removal's row, not a second
    count (the reference counts it twice)."""
    _, t = _pair(data)
    rep = next(r for r, dups in t.instances.items() if len(dups) == 1)
    dup = t.instances[rep][0]
    n0 = t.ntotal + sum(len(v) for v in t.instances.values())
    assert t.remove_ids(TBatch(np.asarray([rep, dup], np.int64))) == 2
    assert rep not in t.instances
    # more generally: the count is the number of stored ids that went
    keys = list(t.instances)
    gone = np.asarray(keys[:5] + [t.instances[keys[5]][0], 3, 4, 10 ** 7],
                      np.int64)
    held = {i for r, ds in t.instances.items() for i in (r, *ds)} | set(
        np.concatenate(t._ids_host).tolist())
    want = len(set(gone.tolist()) & held)
    assert t.remove_ids(TBatch(gone)) == want
    n1 = t.ntotal + sum(len(v) for v in t.instances.values())
    assert n0 - n1 == 2 + want
