"""NN-descent k-NN graph construction and the NSG prune — PyTorch
counterpart of `tpu_ann/ops/nndescent.py` (faiss `impl/NNDescent.{h,cpp}`,
`impl/NSG.{h,cpp}`).

One iteration (`nnd_iter`) is batched over every row: the neighbours of
each row's neighbours and the sampled reverse edges are its candidates,
deduplicated against its current list and each other, scored in f32
against the row and merged into its best K. Only the candidates the
dedupe keeps are gathered and scored (the reference scores all K·K + K and
masks the duplicates after; the result is the same), in row chunks of at
most ``NND_BUDGET`` f32 elements: the reference forms the whole (n, K·K +
K, d) tensor, which at 1M rows and K 64 would be 2 TB. Every sort is
stable, so on a tie the lower position wins, as the reference's
``argsort`` and ``lax.top_k`` do; the products are f32 (TF32 off, see
`ops.distances`) where the reference's TPU runs bf16.

The random streams: the initial graph is the reference's numpy
``RandomState(seed)`` draw, equal in both packages. The reverse edges'
slots (one of K for each (row, neighbour) pair) cannot follow
``jax.random``: `nn_descent` draws them from a CPU ``torch.Generator``
seeded with ``seed`` and moves them to the device, so the card and the
CPU build the same graph; `nnd_iter` takes them as an argument.

`build_nsg` roots the graph at the medoid (the row nearest the mean) and
prunes each row's k-NN list with the MRNG rule (`ops.hnsw.prune_all`, the
diversity heuristic of HNSW's shrink). Like the reference it adds no
connectivity repair: faiss's NSG grows a spanning tree from the medoid.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import distances as D
from .hnsw import dedupe_first, prune_all

# f32 elements of candidate rows gathered at once by an iteration (1 GiB)
NND_BUDGET = 1 << 28


def initial_graph(n: int, K: int, seed: int) -> np.ndarray:
    """(n, K) int32 random neighbours, the reference's draw (:97-100):
    ``RandomState(seed).randint(0, n, (n, K))``, a self-loop moved to the
    next row."""
    rs = np.random.RandomState(seed)
    init = rs.randint(0, n, size=(n, K)).astype(np.int32)
    return np.where(init == np.arange(n)[:, None], (init + 1) % n, init)


def _l2(x: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """||x||^2 + ||v||^2 - 2 x.v of rows x (m, d) and their candidates vecs
    (m, C, d), f32, the reference's expression (not clamped)."""
    ip = torch.bmm(vecs, x[:, :, None])[:, :, 0]
    return (x * x).sum(1)[:, None] + (vecs * vecs).sum(2) - 2.0 * ip


def reverse_slots(n: int, K: int, seed: int, it: int,
                  device) -> torch.Tensor:
    """The slots of iteration ``it``'s reverse edges, (n, K) int64 in [0,
    K), drawn on the CPU from ``torch.Generator`` seed ``seed + it``."""
    g = torch.Generator()
    g.manual_seed(int(seed) + int(it))
    return torch.randint(0, K, (n, K), generator=g).to(device)


def nnd_iter(vectors: torch.Tensor, graph: torch.Tensor,
             gdist: torch.Tensor, slot: torch.Tensor, K: int,
             budget: int = NND_BUDGET):
    """One NN-descent iteration (reference `_nnd_iter`, :29-82). graph (n,
    K) int32 ids (-1 empty), gdist (n, K) f32, slot (n, K) the reverse
    edges' slots. Row j proposes itself to each neighbour t at slot[j, i];
    where several rows write one (t, slot), the last in (j, i) order wins,
    as the reference's scatter does on the CPU. Returns (graph, gdist,
    the number of changed entries as a 0-d tensor)."""
    n, d = vectors.shape
    dev = vectors.device
    vectors = vectors.float()
    gvalid = graph >= 0
    tgt = torch.where(gvalid, graph.long(), n).reshape(-1)
    cell = tgt * K + slot.reshape(-1).long()
    order = torch.arange(n * K, device=dev)
    last = torch.full(((n + 1) * K,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, cell, order, reduce="amax")
    rev = torch.where(last >= 0, last // K, -1).view(n + 1, K)[:n]
    C = K * K + K
    chunk = max(1, budget // (C * d))
    new_g = torch.empty_like(graph)
    new_d = torch.empty_like(gdist)
    updates = torch.zeros((), dtype=torch.long, device=dev)
    vn = (vectors * vectors).sum(1)
    for r0 in range(0, n, chunk):
        g = graph[r0:r0 + chunk]
        m = g.shape[0]
        gd = gdist[r0:r0 + chunk]
        gv = gvalid[r0:r0 + chunk]
        nn = graph[torch.where(gv, g, 0).long()]            # (m, K, K)
        cand = torch.cat([torch.where(gv[:, :, None], nn, -1).view(m, K * K),
                          rev[r0:r0 + chunk].to(graph.dtype)], 1)
        row = torch.arange(r0, r0 + m, device=dev)[:, None]
        valid = (cand >= 0) & (cand != row)
        ci = torch.cat([g, torch.where(valid, cand, -1)], 1)
        # the reference's dedupe keeps an id's first finite entry; a valid
        # candidate's distance is finite, so it is known from the ids, and
        # only the first occurrences of ids new to the row are scored
        keep = dedupe_first(ci, torch.cat([torch.isfinite(gd), valid], 1))
        qi, cj = torch.nonzero(keep[:, K:], as_tuple=True)
        cid = cand[qi, cj].long()
        ip = (vectors[cid] * vectors[r0 + qi]).sum(1)
        dis = torch.full((m, C), float("inf"), device=dev)
        dis[qi, cj] = vn[r0 + qi] + vn[cid] - 2.0 * ip
        cd = torch.cat([torch.where(keep[:, :K], gd, float("inf")), dis], 1)
        sd, pos = torch.sort(cd, dim=1, stable=True)
        sd, pos = sd[:, :K], pos[:, :K]
        ng = torch.where(torch.isfinite(sd), torch.gather(ci, 1, pos), -1)
        new_g[r0:r0 + m] = ng
        new_d[r0:r0 + m] = sd
        updates += (ng != g).sum()
    return new_g, new_d, updates


def nn_descent(vectors: torch.Tensor, K: int, *, iters: int = 10,
               seed: int = 1234, verbose: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A K-NN graph of ``vectors`` (NNDescent::build): (graph (n, K) int32,
    its f32 distances), refined until an iteration changes no entry or
    ``iters`` ran."""
    n, d = vectors.shape
    dev = vectors.device
    vectors = vectors.float()
    graph = torch.from_numpy(initial_graph(n, K, seed)).to(dev)
    gdist = torch.empty((n, K), dtype=torch.float32, device=dev)
    chunk = max(1, NND_BUDGET // (K * d))
    for r0 in range(0, n, chunk):
        gdist[r0:r0 + chunk] = _l2(vectors[r0:r0 + chunk],
                                   vectors[graph[r0:r0 + chunk].long()])
    for it in range(iters):
        graph, gdist, upd = nnd_iter(vectors, graph, gdist,
                                     reverse_slots(n, K, seed, it, dev), K)
        upd = int(upd)
        if verbose:
            print(f"nn_descent iter {it}: {upd} updates")
        if upd == 0:
            break
    return graph, gdist


def build_nsg(vectors: torch.Tensor, knn_graph: torch.Tensor,
              knn_dist: torch.Tensor, R: int, *,
              metric: int = D.METRIC_L2) -> Tuple[torch.Tensor, int]:
    """Prune a k-NN graph into an NSG (NSG::build): each row keeps at most
    R of its neighbours by the MRNG rule, and the entry is the medoid, the
    row nearest the mean of all rows. Returns (adjacency (n, R) int32,
    medoid)."""
    vectors = vectors.float()
    centroid = vectors.mean(0, keepdim=True)
    _, med = D.knn(centroid, vectors, 1, metric)
    adj, _ = prune_all(vectors, knn_graph, knn_dist, R, metric)
    return adj, int(med[0, 0])


def reachable_share(graph: torch.Tensor, entry: int) -> float:
    """The share of rows a breadth-first walk of ``graph`` (n, R) from
    ``entry`` reaches, on the graph's device."""
    n = graph.shape[0]
    seen = torch.zeros(n + 1, dtype=torch.bool, device=graph.device)
    seen[entry] = True
    front = torch.tensor([entry], dtype=torch.long, device=graph.device)
    while front.numel():
        nb = graph[front].reshape(-1).long()
        nb = nb[nb >= 0]
        nb = torch.unique(nb[~seen[nb]])
        seen[nb] = True
        front = nb
    return float(seen[:n].float().mean())
