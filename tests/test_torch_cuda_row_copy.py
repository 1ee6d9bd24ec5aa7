"""The row-copy issue probe (B2, csrc/row_copy_probe.cu) against its plain
torch version on the card. Without a CUDA device these tests skip.

Run on a GPU machine (no jax needed, hence --noconftest):
    python -m pytest --noconftest -q tests/test_torch_cuda_row_copy.py

The slots hold copied rows, so they must equal the plain version bit for
bit."""

import numpy as np
import pytest
import torch

from tpu_ann_torch.ops import row_copy_probe as B2

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("nr,ns,dp", [(4096, 16, 128), (37, 16, 128),
                                      (5, 16, 128), (1000, 32, 96),
                                      (999, 1, 4)])
def test_slots_equal_plain(nr, ns, dp):
    dev = _cuda()
    rs = np.random.RandomState(nr)
    xb = torch.from_numpy(rs.randn(20000, dp).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rs.randint(0, 20000, size=nr).astype(np.int32)
                            ).to(dev)
    before = B2.LAUNCHES
    out, cycles = B2.row_copy_probe(xb, rows, ns)
    torch.cuda.synchronize()
    assert B2.LAUNCHES == before + 1
    np.testing.assert_array_equal(
        out.cpu().numpy(), B2.row_copy_probe_reference(xb, rows, ns).cpu()
        .numpy())
    assert int(cycles.item()) > 0
    assert B2.sm_clock_khz() > 0


def test_probe_rejects_unsupported():
    dev = _cuda()
    xb = torch.zeros((10, 6), device=dev)
    rows = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        B2.row_copy_probe(xb, rows)                 # dp % 4 != 0
    with pytest.raises(ValueError):
        B2.row_copy_probe(torch.zeros((10, 8), device=dev),
                          torch.tensor([3, 10], dtype=torch.int32,
                                       device=dev))
