"""QINCo neural-codec demo (faiss demos/demo_qinco.py — load QINCo
weights and compare sa_encode / sa_decode reconstruction error against PQ
at the same code budget).

faiss loads pretrained PyTorch checkpoints; the repository holds none and
nothing is downloaded, so this demo uses a deterministic random init: the
point is the API surface (IndexQINCo.sa_encode / sa_decode / search), not
trained quality.

    python -m tpu_ann_torch.demos.demo_qinco [--device cpu]
"""

import time

import numpy as np


def main(device="cuda", d=32, K=64, L=2, M=4, h=32, nb=1_000, nq=100, k=10):
    import torch

    from ..models.qinco import IndexQINCo
    from ..ops.pq import pq_decode, pq_encode, train_pq

    rs = np.random.RandomState(3)
    xb = rs.randn(nb, d).astype(np.float32)
    xq = (xb[:nq] + 0.05 * rs.randn(nq, d)).astype(np.float32)

    idx = IndexQINCo(d, K=K, L=L, M=M, h=h, device=device)
    print(f"IndexQINCo d={d} M={M} K={K}: "
          f"{idx.sa_code_size()} bytes/vector")

    t0 = time.time()
    codes = idx.sa_encode(xb)
    print(f"sa_encode {nb} vectors in {time.time()-t0:.1f}s "
          f"(greedy per-step argmin)")
    recon = idx.sa_decode(codes)
    q_err = float(np.mean((xb - recon) ** 2))

    # PQ at the same code budget (M 8-bit subquantizers)
    codec = train_pq(xb, M=M, nbits=8, niter=8, device=device)
    cent = torch.from_numpy(codec.centroids).to(device)
    xb_dev = torch.from_numpy(xb).to(device)
    pq_err = float(((xb_dev - pq_decode(pq_encode(xb_dev, cent), cent))
                    ** 2).mean())
    print(f"reconstruction MSE: qinco(random init)={q_err:.4f} "
          f"trained PQ={pq_err:.4f}")

    idx.add(xb)
    _, I1 = idx.search(xq, k)
    noisy_hit = float(np.mean(I1[:, 0] == np.arange(nq)))
    print(f"decoded-domain search, noisy queries: "
          f"self-hit@1={noisy_hit:.2f} (random init — no trained quality)")

    # Exact-path validation: querying with the decoded reconstructions
    # must return the corresponding database rows. A row whose code equals
    # the query row's decodes to the same vector: the f32 product's
    # rounding, not the row's position, ranks such exact duplicates, so
    # either is the corresponding row.
    _, I2 = idx.search(recon[:nq].astype(np.float32), k)
    id_hit = float(np.mean(I2[:, 0] == np.arange(nq)))
    self_hit = float(np.mean((codes[I2[:, 0]] == codes[:nq]).all(1)))
    print(f"decoded-query self-hit@1={self_hit:.2f} "
          f"(the row's own id first: {id_hit:.2f})")
    assert self_hit > 0.95, self_hit
    print("OK")
    return {"qinco_mse": q_err, "pq_mse": pq_err, "noisy_hit": noisy_hit,
            "self_hit": self_hit, "id_hit": id_hit}


if __name__ == "__main__":
    from . import cli_device

    main(cli_device(__doc__.splitlines()[0]))
