"""The rest of utils/datasets.py and utils/evaluation.py of tpu_ann_torch
against the JAX package's, on the CPU: deep_surrogate and
SiftSurrogateDataset, the fvecs / ivecs / bvecs / fbin / ibin readers and
writers, the loaders over a root directory, dataset_from_name, and the
evaluation helpers (check_self_search, the range precision / recall
helpers, sort_range_res_1 / 2, check_ref_knn_with_draws,
check_ref_range_results).

Every loader test writes its own small files under tmp_path. Tolerances:
the generators, the files and the helpers' outputs are bit-equal (they
are numpy in both packages, and each package reads the files the other
writes); SiftSurrogateDataset's ground truth equals the reference's with
distances exact (integer data) and ids up to ties."""

import os

import numpy as np
import pytest

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.utils import datasets as JD
from tpu_ann.utils import evaluation as JE
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.utils import datasets as TD
from tpu_ann_torch.utils import evaluation as TE


def test_deep_surrogate_bit_equal(tmp_path):
    for kw in ({}, {"chunk": 700}, TD.DEEP10M_CALIBRATED,
               {"d": 48, "nproto": 10, "sigma": 0.5}):
        np.testing.assert_array_equal(TD.deep_surrogate(2000, seed=5, **kw),
                                      JD.deep_surrogate(2000, seed=5, **kw))
    assert TD.DEEP10M_CALIBRATED == JD.DEEP10M_CALIBRATED
    assert TD.DEEP100M_CALIBRATED == JD.DEEP100M_CALIBRATED
    mm = np.lib.format.open_memmap(str(tmp_path / "deep.npy"), mode="w+",
                                   dtype=np.float32, shape=(1500, 96))
    TD.deep_surrogate(1500, seed=3, chunk=400, out=mm)
    np.testing.assert_array_equal(np.asarray(mm),
                                  JD.deep_surrogate(1500, seed=3, chunk=400))
    with pytest.raises(ValueError):
        TD.deep_surrogate(10, d=20)


def test_sift_surrogate_dataset():
    t = TD.SiftSurrogateDataset(nt=100, nb=600, nq=20, seed=9, device="cpu")
    j = JD.SiftSurrogateDataset(nt=100, nb=600, nq=20, seed=9)
    for name in ("get_train", "get_database", "get_queries"):
        np.testing.assert_array_equal(getattr(t, name)(), getattr(j, name)())
    assert (t.d, t.nt, t.nb, t.nq, t.metric) == (j.d, j.nt, j.nb, j.nq,
                                                 j.metric)
    gt_t, gt_j = t.get_groundtruth(5), j.get_groundtruth(5)
    assert gt_t.shape == (20, 5)
    # exact distances of both packages' ground truth, compared as sets of
    # distances (ids may differ only inside ties)
    xb, xq = t.get_database(), t.get_queries()
    d2 = ((xq[:, None, :] - xb[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.take_along_axis(d2, gt_t, 1),
                                  np.take_along_axis(d2, gt_j, 1))


def _write_both(tmp_path, name, writer, arr):
    """Write ``arr`` with each package's writer: the files are
    byte-identical. Returns the path of the port's."""
    pt, pj = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    getattr(TD, writer)(pt, arr)
    getattr(JD, writer)(pj, arr)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    return pt, pj


def test_vecs_and_bin_files(tmp_path):
    """Each package's writers give the same bytes, and each reads the
    other's files, whole and bounded."""
    rs = np.random.RandomState(2)
    xf = rs.randn(57, 12).astype(np.float32)
    xi = rs.randint(-5, 1000, (40, 7)).astype(np.int32)
    xu = rs.randint(0, 256, (33, 16)).astype(np.uint8)
    for writer, reader, arr in (("fvecs_write", "fvecs_read", xf),
                                ("ivecs_write", "ivecs_read", xi),
                                ("bvecs_write", "bvecs_read", xu)):
        pt, pj = _write_both(tmp_path, writer, writer, arr)
        for path in (pt, pj):
            for mod in (TD, JD):
                np.testing.assert_array_equal(getattr(mod, reader)(path),
                                              arr)
                np.testing.assert_array_equal(
                    getattr(mod, reader)(path, maxn=9), arr[:9])
    pt, pj = _write_both(tmp_path, "x.fbin", "write_fbin", xf)
    for path in (pt, pj):
        np.testing.assert_array_equal(TD.read_fbin(path), xf)
        np.testing.assert_array_equal(TD.read_fbin(path, 10, 20), xf[10:30])
        np.testing.assert_array_equal(TD.read_fbin(path, 50),
                                      JD.read_fbin(path, 50))
    ib = str(tmp_path / "x.ibin")
    with open(ib, "wb") as f:
        np.asarray(xi.shape, np.int32).tofile(f)
        xi.tofile(f)
    np.testing.assert_array_equal(TD.read_ibin(ib), JD.read_ibin(ib))
    np.testing.assert_array_equal(TD.read_ibin(ib), xi)


def test_loaders(tmp_path):
    """load_sift1m / load_gist1m / load_deep1b / DatasetBigANN over small
    files in a root directory: the same arrays as the reference's loaders;
    a loader without its files raises FileNotFoundError."""
    rs = np.random.RandomState(4)
    root = str(tmp_path)
    for prefix, d in (("sift", 16), ("gist", 24), ("deep", 8)):
        for part, n in (("base", 80), ("learn", 40), ("query", 10)):
            TD.fvecs_write(os.path.join(root, f"{prefix}_{part}.fvecs"),
                           rs.randn(n, d).astype(np.float32))
        TD.ivecs_write(os.path.join(root, f"{prefix}_groundtruth.ivecs"),
                       rs.randint(0, 80, (10, 20)))
    pairs = [(TD.load_sift1m(root), JD.load_sift1m(root)),
             (TD.load_gist1m(root), JD.load_gist1m(root)),
             (TD.load_deep1b(root, nb=50), JD.load_deep1b(root, nb=50))]
    xu = rs.randint(0, 256, (100, 16)).astype(np.uint8)
    TD.bvecs_write(os.path.join(root, "bigann_base.bvecs"), xu)
    TD.bvecs_write(os.path.join(root, "bigann_learn.bvecs"), xu[:50])
    TD.bvecs_write(os.path.join(root, "bigann_query.bvecs"), xu[:10])
    os.makedirs(os.path.join(root, "gnd"))
    TD.ivecs_write(os.path.join(root, "gnd", "idx_1M.ivecs"),
                   rs.randint(0, 100, (10, 5)))
    pairs.append((TD.DatasetBigANN(root, nb_M=1),
                  JD.DatasetBigANN(root, nb_M=1)))
    for t, j in pairs:
        assert (t.d, t.nt, t.nb, t.nq) == (j.d, j.nt, j.nb, j.nq)
        np.testing.assert_array_equal(t.get_train(), j.get_train())
        np.testing.assert_array_equal(t.get_train(7), j.get_train(7))
        np.testing.assert_array_equal(t.get_database(), j.get_database())
        np.testing.assert_array_equal(t.get_queries(), j.get_queries())
        np.testing.assert_array_equal(t.get_groundtruth(3),
                                      j.get_groundtruth(3))
    chunks = list(pairs[-1][0].database_iterator(bs=30))
    assert [len(c) for c in chunks] == [30, 30, 30, 10]
    np.testing.assert_array_equal(np.vstack(chunks), xu.astype(np.float32))
    with pytest.raises(FileNotFoundError):
        TD.load_sift1m(str(tmp_path / "absent"))


def test_dataset_from_name():
    t = TD.dataset_from_name("synthetic-16-100-500-10", device="cpu")
    j = JD.dataset_from_name("synthetic-16-100-500-10")
    np.testing.assert_array_equal(t.get_database(), j.get_database())
    np.testing.assert_array_equal(t.get_queries(), j.get_queries())
    assert t.get_groundtruth(4).shape == (10, 4)
    t = TD.dataset_from_name("sift-surrogate-100-400-10", device="cpu")
    j = JD.dataset_from_name("sift-surrogate-100-400-10")
    np.testing.assert_array_equal(t.get_database(), j.get_database())
    with pytest.raises(ValueError):
        TD.dataset_from_name("sift1M")
    with pytest.raises(ValueError):
        TD.dataset_from_name("nope")


@pytest.fixture(scope="module")
def ranges():
    """An exact range search of the port's IndexFlat and a partial one (a
    radius half as wide), on integer data."""
    rs = np.random.RandomState(6)
    xb = rs.randint(0, 16, (1500, 12)).astype(np.float32)
    xq = rs.randint(0, 16, (30, 12)).astype(np.float32)
    flat = TFlat(12, device="cpu")
    flat.add(xb)
    Dk, _ = flat.search(xq, 10)
    radius = float(np.median(Dk[:, 9]))
    ref = flat.range_search(xq, radius)
    new = flat.range_search(xq, radius * 0.6)
    return flat, xb, xq, radius, ref, new


def test_range_evaluation_helpers(ranges):
    """filter_range_results, counts_to_PR, range_PR,
    range_PR_multiple_thresholds and sort_range_res_1 / 2 give the
    reference's outputs bit for bit on the same results."""
    _, _, _, radius, (Lr, Dr, Ir), (Ln, Dn, In) = ranges
    for a, b in zip(TE.filter_range_results(Ln, Dn, In, radius * 0.3),
                    JE.filter_range_results(Ln, Dn, In, radius * 0.3)):
        np.testing.assert_array_equal(a, b)
    for mode in ("overall", "average"):
        assert TE.range_PR(Lr, Ir, Ln, In, mode) == \
            JE.range_PR(Lr, Ir, Ln, In, mode)
        np.testing.assert_array_equal(
            TE.range_PR_multiple_thresholds(Lr, Ir, Ln, Dn, In,
                                            [radius * 0.3, radius], mode),
            JE.range_PR_multiple_thresholds(Lr, Ir, Ln, Dn, In,
                                            [radius * 0.3, radius], mode))
    p, r = TE.range_PR(Lr, Ir, Ln, In)
    assert p == 1.0 and 0 < r < 1.0
    for case in (([5], [0], [0]), ([0], [5], [0]), ([0], [0], [0]),
                 ([3, 4], [2, 6], [1, 4])):
        for mode in ("overall", "average"):
            assert TE.counts_to_PR(*case, mode=mode) == \
                JE.counts_to_PR(*case, mode=mode)
    with pytest.raises(ValueError):
        TE.counts_to_PR([1], [1], [1], mode="nope")
    with pytest.raises(ValueError):
        TE.range_PR(Lr, Ir, Ln[:-1], In)
    np.testing.assert_array_equal(TE.sort_range_res_1(Lr, Ir),
                                  JE.sort_range_res_1(Lr, Ir))
    for a, b in zip(TE.sort_range_res_2(Lr, Dr, Ir),
                    JE.sort_range_res_2(Lr, Dr, Ir)):
        np.testing.assert_array_equal(a, b)


def test_result_checks(ranges):
    """check_ref_knn_with_draws / check_ref_range_results pass and fail
    where the reference's do; check_self_search on the port's index."""
    flat, xb, xq, radius, (Lr, Dr, Ir), _ = ranges
    Dk, Ik = flat.search(xq, 6)
    jflat = JFlat(12)
    jflat.add(xb)
    # the same result with each row's equal distances in reverse order
    Iw = Ik.copy()
    for r in range(len(Dk)):
        Iw[r] = Ik[r][np.lexsort((-np.arange(6), Dk[r]))]
    assert (Iw != Ik).any()
    for mod in (TE, JE):
        mod.check_ref_knn_with_draws(Dk, Ik, Dk, Iw)
        bad = Ik.copy()
        bad[0, 0] = -7
        with pytest.raises(AssertionError):
            mod.check_ref_knn_with_draws(Dk, Ik, Dk, bad)
    Ljr, Djr, Ijr = jflat.range_search(xq, radius)
    for mod in (TE, JE):
        mod.check_ref_range_results(Ljr, Djr, Ijr, Lr, Dr, Ir)
        with pytest.raises(AssertionError):
            mod.check_ref_range_results(Lr, Dr, Ir, Lr, Dr, Ir[::-1])
    uniq = TFlat(12, device="cpu")
    uniq.add(np.unique(xb, axis=0)[:500])
    assert TE.check_self_search(uniq, np.unique(xb, axis=0)[:500])
    assert not TE.check_self_search(uniq, np.unique(xb, axis=0)[1:501])
