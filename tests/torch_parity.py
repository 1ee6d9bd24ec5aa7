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

