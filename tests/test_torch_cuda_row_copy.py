"""The row-copy issue probe (B2, csrc/row_copy_probe.cu) against its plain
torch version on the card. Without a CUDA device these tests skip.

Run on a GPU machine (no jax needed, hence --noconftest):
    python -m pytest --noconftest -q tests/test_torch_cuda_row_copy.py

The slots hold copied rows and the XOR folds their bit patterns, so both
must equal the plain version bit for bit."""

import numpy as np
import pytest
import torch

from tpu_ann_torch.ops import row_copy_probe as B2

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _probe_and_check(dev, nr, ns, dp, nb=20000):
    rs = np.random.RandomState(nr + dp)
    xb = torch.from_numpy(rs.randn(nb, dp).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rs.randint(0, nb, size=nr).astype(np.int32)
                            ).to(dev)
    before = B2.LAUNCHES
    out, xor, cycles = B2.row_copy_probe(xb, rows, ns)
    torch.cuda.synchronize()
    assert B2.LAUNCHES == before + 1
    ref, ref_xor = B2.row_copy_probe_reference(xb, rows, ns)
    np.testing.assert_array_equal(out.cpu().numpy().view(np.int32),
                                  ref.cpu().numpy().view(np.int32))
    np.testing.assert_array_equal(xor.cpu().numpy(), ref_xor.cpu().numpy())
    copies = B2.cta_copies(nr, cycles.numel())
    assert sum(copies) == nr
    cyc = cycles.cpu().numpy()
    assert all(c > 0 for c, n in zip(cyc, copies) if n)
    return cycles


@pytest.mark.parametrize("nr,ns,dp", [(4096, 16, 128), (37, 16, 128),
                                      (5, 16, 128), (1000, 32, 96),
                                      (999, 1, 4)])
def test_slots_equal_plain(nr, ns, dp):
    dev = _cuda()
    _probe_and_check(dev, nr, ns, dp)
    assert B2.sm_clock_khz() > 0


@pytest.mark.parametrize("dp", [4, 96, 128, 512])
@pytest.mark.parametrize("nr", [0, 1, 15, 16, 10007, 65536])
def test_slots_and_xor_equal_plain(nr, dp):
    """NR 0, 1, NS - 1, NS, a prime (so the CTAs' ranges differ in length)
    and 65536 rows: every row's copy lands in the XOR."""
    dev = _cuda()
    cycles = _probe_and_check(dev, nr, 16, dp)
    copies = B2.cta_copies(nr, cycles.numel())
    if nr >= cycles.numel():
        assert min(copies) >= 1
    if nr == 10007:
        assert len(set(copies)) == 2


def test_widest_row():
    dev = _cuda()
    dp_max = B2._lib()["dp_max"]()
    _probe_and_check(dev, 3000, 16, dp_max, nb=4000)
    with pytest.raises(ValueError):
        B2.row_copy_probe(torch.zeros((10, dp_max + 4), device=dev),
                          torch.zeros(3, dtype=torch.int32, device=dev))


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
