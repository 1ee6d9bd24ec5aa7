"""Residual-quantizer demo (faiss demos/demo_residual_quantizer.cpp —
train an RQ codec, compare reconstruction error against PQ at the same
code budget, and run an IndexResidualQuantizer search).

    python -m tpu_ann_torch.demos.demo_residual_quantizer [--device cpu]
"""

import time

import numpy as np


def make_data(d=32, nb=10_000, nt=5_000, nq=200, seed=5):
    """Clustered data: isotropic gaussian noise around 256 shared
    prototypes (a 32-bit code can't capture 32 i.i.d. gaussian dims — real
    ANN datasets have structure, so should a codec demo). Returns (xt, xb,
    xq), the queries noisy copies of the first database rows."""
    rs = np.random.RandomState(seed)
    protos = rs.randn(256, d).astype(np.float32)

    def draw(n):
        return (protos[rs.randint(256, size=n)]
                + 0.25 * rs.randn(n, d)).astype(np.float32)

    xt, xb = draw(nt), draw(nb)
    xq = (xb[:nq] + 0.05 * rs.randn(nq, d)).astype(np.float32)
    return xt, xb, xq


def codec_mse(xt, xb, M=4, nbits=8, niter=8, beam=8, device="cuda"):
    """(RQ, PQ) reconstruction MSE of xb at the same M * nbits budget,
    each codec trained on xt."""
    import torch

    from ..ops.pq import pq_decode, pq_encode, train_pq
    from ..ops.rq import rq_decode, rq_encode, train_rq

    xb_dev = torch.from_numpy(xb).to(device)
    t0 = time.time()
    rq = train_rq(xt, M=M, nbits=nbits, niter=niter, device=device)
    print(f"RQ trained in {time.time()-t0:.1f}s "
          f"({M}x{nbits}-bit, beam search encode)")
    books = torch.from_numpy(rq.codebooks).to(device)
    codes = rq_encode(xb_dev, books, beam=beam)
    rq_err = float(((xb_dev - rq_decode(codes, books)) ** 2).mean())

    pq = train_pq(xt, M=M, nbits=nbits, niter=niter, device=device)
    cent = torch.from_numpy(pq.centroids).to(device)
    pq_err = float(((xb_dev - pq_decode(pq_encode(xb_dev, cent), cent))
                    ** 2).mean())
    return rq_err, pq_err


def main(device="cuda", d=32, M=4, nbits=8, nb=10_000, nt=5_000, nq=200,
         k=10):
    import torch

    from ..models.rq import IndexResidualQuantizer
    from ..ops import distances as D
    from ..utils.evaluation import recall_k_at_k

    xt, xb, xq = make_data(d, nb, nt, nq)

    # codec-level comparison at the same M*nbits budget
    rq_err, pq_err = codec_mse(xt, xb, M, nbits, device=device)
    print(f"reconstruction MSE: RQ={rq_err:.4f} PQ={pq_err:.4f} "
          f"(RQ should win: codebooks see the running residual)")
    assert rq_err < pq_err

    # index-level search
    idx = IndexResidualQuantizer(d, M=M, nbits=nbits, device=device)
    idx.train(xt)
    idx.add(xb)
    _, I1 = idx.search(xq, k)
    _, gt = D.knn(torch.from_numpy(xq).to(device),
                  torch.from_numpy(xb).to(device), k)
    rec = recall_k_at_k(I1, gt.cpu().numpy(), k)
    print(f"IndexResidualQuantizer recall@{k} vs exact = {rec:.4f}")
    assert rec > 0.5, rec
    print("OK")
    return {"rq_mse": rq_err, "pq_mse": pq_err, "recall": rec}


if __name__ == "__main__":
    from . import cli_device

    main(cli_device(__doc__.splitlines()[0]))
