"""The control on the card: the plain reference computed in TF32 (one
precision below the float32 the configurations state) put in the
program's place comes out not correct under each cell's limits, while the
program, on the same data, comes out correct. The cells run at their own
configuration with a 20k-query pool and a one-second window."""

import json
import os

import numpy as np
import pytest

from portbench.core import checks, session, spec

from .conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = tuple(w["name"] for w in json.load(_f)["workloads"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(cuda_device, name):
    cell = spec.load_cell(os.path.join(ROOT, "BENCHMARK.json"), name)
    cell.traffic = dict(cell.traffic, pool=20000)
    prep = session.prepare(cell, 2**31 + 1234, cuda_device, trace=False)
    runs, _, _ = session.window(prep, 1.0, trace=False)
    session.release(prep)
    judged = session.judge(prep, runs)
    for n in session.CHECKED:
        assert judged.numbers[n] <= cell.limits[n], (n, judged.numbers)
    ctrl = prep.reference.IVFFlatL2(judged.xb, judged.cent, tf32=True,
                                    rel_tol=0.0)
    a = ctrl.answers(judged.pool, prep.k, prep.nprobe)
    n = len(prep.pool)
    got = checks.compare(
        checks.Compared(np.arange(n), a.high_d.cpu().numpy(),
                        a.ivf_i.cpu().numpy().astype(np.float64), n),
        judged.answers, judged.pool, judged.xb,
        prep.reference.row_distances)
    assert got["wrong_answers"] > cell.limits["wrong_answers"], got
