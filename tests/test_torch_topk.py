"""Port parity for the k-selection primitives (tpu_ann_torch.ops.topk):
`topk_with_ids` and `merge_topk` against the JAX package's on seeded
inputs full of ties, L2 (smaller is better) and IP (bigger is better).
Both sides select by a stable order, so values and ids must be equal bit
for bit: on equal scores the lower index, and in a merge the first
operand, wins."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import topk as JT
from tpu_ann_torch.ops import topk as TT


def _scores(rs, shape, with_inf):
    """Integer-valued scores in [0, 6): most entries tie with others."""
    s = rs.randint(0, 6, size=shape).astype(np.float32)
    if with_inf:
        s[rs.rand(*shape) < 0.2] = np.inf
    return s


@pytest.mark.parametrize("similarity", [False, True])
@pytest.mark.parametrize("width,k", [(17, 5), (64, 64), (40, 1)])
def test_topk_with_ids_matches_reference(similarity, width, k):
    rs = np.random.RandomState(width + k)
    s = _scores(rs, (9, width), with_inf=not similarity)
    ids = rs.randint(-1, 1000, size=(9, width)).astype(np.int32)
    v0, i0 = JT.topk_with_ids(jnp.asarray(s), jnp.asarray(ids), k,
                              similarity=similarity)
    v1, i1 = TT.topk_with_ids(torch.from_numpy(s), torch.from_numpy(ids), k,
                              similarity=similarity)
    np.testing.assert_array_equal(v1.numpy(), np.asarray(v0))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))


@pytest.mark.parametrize("similarity", [False, True])
@pytest.mark.parametrize("k1,k2,k", [(16, 16, 16), (10, 4, 7), (1, 30, 12)])
def test_merge_topk_matches_reference(similarity, k1, k2, k):
    """Two sorted partial results merge to the reference's set; the
    first operand wins ties (the running result of the paged scan)."""
    rs = np.random.RandomState(k1 * 31 + k2)
    parts = []
    for kk, base in ((k1, 0), (k2, 5000)):
        s = np.sort(_scores(rs, (11, kk), with_inf=not similarity), axis=1)
        if similarity:
            s = s[:, ::-1].copy()
        ids = (base + rs.randint(0, 1000, size=(11, kk))).astype(np.int32)
        parts += [s, ids]
    d1, i1, d2, i2 = parts
    v0, o0 = JT.merge_topk(*(jnp.asarray(a) for a in parts), k,
                           similarity=similarity)
    v1, o1 = TT.merge_topk(*(torch.from_numpy(a) for a in parts), k,
                           similarity=similarity)
    np.testing.assert_array_equal(v1.numpy(), np.asarray(v0))
    np.testing.assert_array_equal(o1.numpy(), np.asarray(o0))
    # on a tie between the operands the first one's entries come first
    # (its ids are < 5000)
    for v_row, o_row in zip(v1.numpy(), o1.numpy()):
        for v in np.unique(v_row):
            second = o_row[v_row == v] >= 5000
            assert not (second[:-1] & ~second[1:]).any(), (v_row, o_row)
