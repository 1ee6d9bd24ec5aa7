"""Port parity: tpu_ann_torch.ops.row_copy_probe (B2, the plain version of
its CUDA kernel, on the CPU) against the round-5 harness's DMA-issue kernel
(`benchs/r5/r5_queue7.py` kern2) run in Pallas interpret mode on the same
numpy inputs.

The harness defines kern2 inside a function and writes only out[0, 0], so
this test keeps its own copy of it that writes all NS slots; the copies,
the slot rule (copy i to slot i % NS, wait before reuse, drain at the end)
are kern2's. Tolerance: the slots are copied rows, so they must be equal
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_ann_torch.ops import row_copy_probe as B2


def _kern2(rows, xb, NS):
    NR = rows.shape[1]
    dp = xb.shape[1]

    def kern(rows_ref, xb_hbm, out_ref, buf, sems):
        def body(i, _):
            slot = jax.lax.rem(i, NS)
            r = rows_ref[0, i]
            cp = pltpu.make_async_copy(
                xb_hbm.at[pl.ds(r, 1)], buf.at[pl.ds(slot, 1)],
                sems.at[slot])

            @pl.when(i >= NS)
            def _():
                cp.wait()   # retire the previous copy in this slot

            cp.start()
            return 0

        jax.lax.fori_loop(0, NR, body, 0)

        def wdone(s, _):
            pltpu.make_async_copy(
                xb_hbm.at[pl.ds(0, 1)], buf.at[pl.ds(s, 1)],
                sems.at[s]).wait()
            return 0

        jax.lax.fori_loop(0, min(NS, NR), wdone, 0)
        out_ref[...] = buf[...]

    return pl.pallas_call(
        kern,
        grid=(1,),
        in_specs=[pl.BlockSpec((1, NR), lambda t: (t, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((NS, dp), lambda t: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((NS, dp), jnp.float32),
        scratch_shapes=[pltpu.VMEM((NS, dp), jnp.float32),
                        pltpu.SemaphoreType.DMA((NS,))],
        interpret=True,
    )(rows, xb)


@pytest.mark.parametrize("NR,NS", [(16, 16), (40, 16), (100, 16), (37, 4)])
def test_slots_equal_the_reference_kernel(NR, NS):
    rs = np.random.RandomState(NR)
    xb = rs.randn(1000, 128).astype(np.float32)
    rows = rs.randint(0, 1000, size=NR).astype(np.int32)
    ref = np.asarray(_kern2(jnp.asarray(rows[None]), jnp.asarray(xb), NS))
    out, cycles = B2.row_copy_probe(torch.from_numpy(xb),
                                    torch.from_numpy(rows), NS)
    assert cycles is None
    np.testing.assert_array_equal(out.numpy(), ref)


def test_fewer_rows_than_slots_leave_zeros():
    rs = np.random.RandomState(3)
    xb = torch.from_numpy(rs.randn(50, 8).astype(np.float32))
    rows = torch.tensor([7, 3, 9], dtype=torch.int32)
    out, _ = B2.row_copy_probe(xb, rows, 16)
    np.testing.assert_array_equal(out[:3].numpy(), xb[[7, 3, 9]].numpy())
    assert (out[3:] == 0).all()


def test_argument_checks():
    xb = torch.zeros((4, 8))
    rows = torch.zeros(3, dtype=torch.int32)
    for ns in (0, B2.NS_MAX + 1):
        with pytest.raises(ValueError):
            B2.row_copy_probe(xb, rows, ns)
