"""Shared checks for the parity tests of the PyTorch port (tpu_ann_torch)
against the JAX package."""

import numpy as np


def assert_topk_equal(D0, I0, D1, I1, rtol=0.0, atol=0.0):
    """(D, I) top-k results agree: distances within (rtol, atol), ids equal
    up to ties. Within a row, positions whose reference distances are equal
    (within the tolerance) form a tie group; every group except the last
    must hold the same ids, since all its members made the cut. The last
    group sits at the cut, where either package may keep any of the tied
    ids."""
    D0, D1 = np.asarray(D0), np.asarray(D1)
    I0, I1 = np.asarray(I0), np.asarray(I1)
    assert D0.shape == D1.shape == I0.shape == I1.shape, \
        (D0.shape, D1.shape, I0.shape, I1.shape)
    np.testing.assert_allclose(D1, D0, rtol=rtol, atol=atol)
    for r in range(D0.shape[0]):
        row = D0[r]
        start = 0
        for i in range(1, len(row) + 1):
            if i < len(row) and np.isclose(row[i], row[start], rtol=rtol,
                                           atol=atol, equal_nan=True):
                continue
            if i < len(row):          # a group closed before the cut
                assert sorted(I0[r, start:i]) == sorted(I1[r, start:i]), \
                    (r, row[start], I0[r], I1[r])
            start = i



# Plan shapes that the fused scan kernels' segment walk must handle, with
# the (nlist, block size, rows) of the lists they are drawn over:
#   sparse    probes drawn from every 7th list, so each tile's block hull
#             holds lists no pair probes;
#   one_pair  nprobe 1 over 1000 lists: segments of one pair;
#   one_list  every query probes list 5: tiles whose 128 pairs share it;
#   b16       block size 16 and lists of about 10 rows: several lists in a
#             64-row chunk of the hull (the caller's nearest-list probes).
PLAN_CASES = {"sparse": (280, 128, 8000), "one_pair": (1000, 32, 8000),
              "one_list": (40, 128, 4000), "b16": (400, 16, 4000)}


def case_probes(case, probes, nlist, seed=1):
    """The (nq, nprobe) int32 probes of a plan shape (every 5th query's
    last probe -1); ``probes`` (numpy) is returned for "b16"."""
    rs = np.random.RandomState(seed)
    nq = len(probes)
    if case == "b16":
        return probes
    if case == "sparse":
        out = np.stack([rs.choice(np.arange(0, nlist, 7), 6, replace=False)
                        for _ in range(nq)])
    elif case == "one_pair":
        out = rs.randint(0, nlist, size=(nq, 1))
    else:
        out = np.stack([np.r_[5, rs.choice(np.r_[0:5, 6:nlist], 5,
                                            replace=False)]
                        for _ in range(nq)])
    out = out.astype(np.int32)
    out[::5, -1] = -1
    return out


def check_plan_case(case, plan, B):
    """The plan (a PairPlan of 128-pair tiles) has its case's shape."""
    ps = plan.pstart.view(plan.ntiles, -1).cpu().numpy()
    pe = plan.pend.view(plan.ntiles, -1).cpu().numpy()
    real = pe > ps
    if case == "sparse":
        # a tile's block hull is wider than the lists its pairs probe
        assert any(m.any() and r1[m].max() - r0[m].min() > sum(
            e - s for s, e in set(zip(r0[m], r1[m])))
            for r0, r1, m in zip(ps, pe, real))
    elif case == "one_pair":
        assert any(len(set(r[m])) >= 0.8 * m.sum() > 32
                   for r, m in zip(ps, real))
    elif case == "one_list":
        assert any(m.all() and len(set(r)) == 1 for r, m in zip(ps, real))
    else:
        assert np.median((pe - ps)[real]) * B <= 32
