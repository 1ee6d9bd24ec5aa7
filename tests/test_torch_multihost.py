"""Port twin of tests/test_multihost.py: two real processes joined through
`tpu_ann_torch.parallel.initialize_multihost(backend="gloo")` on a free
local port, each holding half of the database, drive `sharded_knn` across
the process boundary; every process's result must equal the exact k-NN."""

import pickle

import numpy as np

from torch_sharded_world import multihost_knn, spawn_world


def test_two_process_distributed_sharded_knn(tmp_path):
    codes, hung = spawn_world(multihost_knn, 2, (str(tmp_path),),
                              timeout=120)
    errs = [p.read_text() for p in tmp_path.glob("rank*.err")]
    assert not hung, "the two processes hung and were killed"
    assert codes == [0, 0], (codes, errs)
    outs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    xb, xq = outs[0]["xb"], outs[0]["xq"]
    d2 = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :4]
    for out in outs:
        np.testing.assert_array_equal(out["I"], gt)
        np.testing.assert_allclose(out["D"], np.take_along_axis(d2, gt, 1),
                                   rtol=1e-5)
