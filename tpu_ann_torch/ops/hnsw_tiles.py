"""Tile-granular HNSW traversal — PyTorch counterpart of the fused route of
`tpu_ann/ops/hnsw_tiles.py`.

The reference's level-0 search pops one node at a time and reads its
neighbours' vectors one by one. Here the vectors are stored in SPATIAL
ORDER (k-means cells of about a tile) as packed invlists whose lists are
fixed tiles of ``b`` consecutive positions, so "visit a node" becomes "scan
its whole tile" with the list-major fused scan (K3,
`ivf_scan_fused.scan_invlists_fused`), which re-ranks in exact f32:

* hop 0 routes each query to its top-nprobe0 tiles by one product over the
  tile centroids (the role of the upper levels) and scans them;
* each graph hop expands the best ``expand`` positions found so far
  through the level-0 adjacency, maps their neighbours to tiles, keeps the
  first F tiles not scanned yet (in parent-rank order) and scans them;
* results merge into a running top-rk; positions map back to node ids.

So a search is 1 + hops launches of K3. The kernel keeps at most KP_MAX
(32) candidates per (query, tile); a wider kp (an HNSW coarse quantizer
asked for 64 lists) scans each tile as sub-lists of 32 rows, each kept
whole, a superset of the reference's top-kp per tile. The reference's XLA-beam
`TileGraph` / `tile_search` and the PQ tiles are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import distances as D
from . import topk as TK
from .hnsw import dedupe_first
from .ivf_scan import PackedInvLists, pack_invlists
from .ivf_scan_fused import KP_MAX, scan_invlists_fused
from .kmeans import ClusteringParameters, kmeans


def spatial_order(x: np.ndarray, b: int, *,
                  assign: Optional[np.ndarray] = None, seed: int = 1234,
                  device="cuda") -> np.ndarray:
    """Node order that makes consecutive b-sized tiles spatially tight
    (reference :51): by (k-means cell of about b rows, distance to its
    centroid), or by an existing coarse assignment."""
    x = np.ascontiguousarray(np.asarray(x), np.float32)
    n = x.shape[0]
    if assign is None:
        nlist = int(np.clip(n // b, 16, 65536))
        if n < 2 * nlist:
            return np.arange(n, dtype=np.int64)
        cp = ClusteringParameters(niter=6, seed=seed,
                                  max_points_per_centroid=64)
        cents, _ = kmeans(x, nlist, cp, device=device)
        dis, idx = D.knn(torch.from_numpy(x).to(device),
                         torch.from_numpy(cents).to(device), 1,
                         compute_dtype="bfloat16", approx=nlist > 4096)
        assign = idx[:, 0].cpu().numpy().astype(np.int64)
        cdis = dis[:, 0].cpu().numpy()
    else:
        assign = np.asarray(assign, np.int64)
        cdis = np.zeros(n, np.float32)
    return np.lexsort((cdis, assign)).astype(np.int64)


@dataclasses.dataclass
class FusedTileGraph:
    """Tiles as packed invlists (list i = tile i = positions [i*b, i*b +
    b), f32 storage for the exact re-rank), the tile centroids for hop-0
    routing and the position-space level-0 adjacency (reference :337)."""

    il: PackedInvLists
    cent: torch.Tensor       # (T, d) f32 tile centroids
    nbr_pos: torch.Tensor    # (T*b, M0) int32 neighbour POSITIONS (-1 pad)
    orig_ids: torch.Tensor   # (T*b,) int32 position -> node id (-1 pad)
    b: int = 128
    n: int = 0


def build_tiles_fused(x: np.ndarray, neighbors0, *,
                      order: Optional[np.ndarray] = None, b: int = 128,
                      device="cuda") -> FusedTileGraph:
    """FusedTileGraph from vectors (node-id order) and the level-0 graph
    (reference :359): rows in ``order`` packed as lists of b positions."""
    x = np.ascontiguousarray(np.asarray(x), np.float32)
    n, d = x.shape
    order = np.arange(n, dtype=np.int64) if order is None else \
        np.asarray(order, np.int64)
    pos_of = np.empty(n, np.int64)
    pos_of[order] = np.arange(n)
    T = max(-(-n // b), 1)
    xs = x[order]
    il = pack_invlists(xs, np.arange(n, dtype=np.int64),
                       np.arange(n, dtype=np.int64) // b, T, block_size=b,
                       device=device)
    pad_rows = T * b - n
    xs_p = np.concatenate([xs, np.zeros((pad_rows, d), np.float32)]) \
        if pad_rows else xs
    cnt = np.full(T, b, np.float32)
    if pad_rows:
        cnt[-1] = b - pad_rows
    cent = (xs_p.reshape(T, b, d).sum(axis=1, dtype=np.float64)
            / np.maximum(cnt, 1.0)[:, None]).astype(np.float32)
    nb = np.asarray(torch.as_tensor(neighbors0).cpu(), np.int64)
    nbr = np.full((T * b, nb.shape[1]), -1, np.int32)
    ok = nb >= 0
    nbr[:n] = np.where(ok, pos_of[np.where(ok, nb, 0)], -1)[order]
    orig_ids = np.full(T * b, -1, np.int32)
    orig_ids[:n] = order
    return FusedTileGraph(il=il, cent=torch.from_numpy(cent).to(device),
                          nbr_pos=torch.from_numpy(nbr).to(device),
                          orig_ids=torch.from_numpy(orig_ids).to(device),
                          b=b, n=n)


def sub_tiles(il: PackedInvLists, rows: int) -> PackedInvLists:
    """The tile lists of ``il`` (one block of B rows each) viewed as B /
    rows lists of ``rows`` rows each, without a copy: sub-list t * (B /
    rows) + j holds rows [j * rows, (j + 1) * rows) of tile t, at the same
    stream positions."""
    B = il.block_size
    s = B // rows
    nb1, d = il.data.shape[0], il.data.shape[2]
    T = il.nlist
    dev = il.data.device
    return PackedInvLists(
        data=il.data.view(nb1 * s, rows, d),
        data_bf16=il.data_bf16.view(nb1 * s, rows, d),
        ids=il.ids.view(nb1 * s, rows), norms=il.norms.view(nb1 * s, rows),
        list_block_start=torch.arange(T * s, dtype=torch.int32, device=dev),
        list_nblocks=torch.ones(T * s, dtype=torch.int32, device=dev))


def _scan_tiles(xq, probes, ftg: FusedTileGraph, k: int, metric: int,
                kp: int):
    """One fused scan of the probed tiles (-1 probes skipped), keeping kp
    candidates per (query, tile). The kernel keeps at most KP_MAX per
    pair: a wider kp scans each tile as sub-lists of KP_MAX rows that each
    keep all their rows, a superset of the tile's top-kp."""
    if kp <= KP_MAX:
        return scan_invlists_fused(xq, probes, ftg.il, k, metric, kp=kp,
                                   refine=4)
    if ftg.b % KP_MAX:
        raise ValueError(f"tile_search_fused: kp={kp} > {KP_MAX} needs a "
                         f"tile size that is a multiple of {KP_MAX}")
    s = ftg.b // KP_MAX
    fine = probes[:, :, None] * s + torch.arange(s, device=probes.device)
    fine = torch.where(probes[:, :, None] >= 0, fine, -1)
    return scan_invlists_fused(xq, fine.reshape(len(probes), -1).to(
        torch.int32), sub_tiles(ftg.il, KP_MAX), k, metric, kp=KP_MAX,
        refine=4)


def tile_search_fused(ftg: FusedTileGraph, xq: torch.Tensor, k: int, *,
                      nprobe0: int = 16, hops: int = 2, expand: int = 8,
                      F: int = 8, kp: int = 8, rk: int = 32,
                      metric: int = D.METRIC_L2):
    """Graph-accelerated tile search on the fused scan (reference :447; see
    the module docstring). Every scan keeps kp per (query, tile) (see
    `_scan_tiles` for kp above the kernel's KP_MAX) and re-ranks the top
    4 x its width in exact f32.
    Returns (dists (nq, k) user-facing, positions (nq, k), ids (nq, k)
    int64 node ids, -1 for empty slots)."""
    similarity = D.is_similarity_metric(metric)
    nq = xq.shape[0]
    b = ftg.b
    T = ftg.il.nlist
    xq = xq.float()
    _, seeds = D.knn(xq, ftg.cent, min(nprobe0, T), metric,
                     compute_dtype="bfloat16", approx=T > 4096)
    seeds = seeds.to(torch.int32)
    bd, bpos, _ = _scan_tiles(xq, seeds, ftg, min(rk, nprobe0 * kp), metric,
                              kp)
    # positions come back through the ids channel (ids == positions)
    hist = seeds
    m0 = ftg.nbr_pos.shape[1]
    for _ in range(hops):
        top = bpos[:, :expand]
        okp = top >= 0
        cand = ftg.nbr_pos[torch.where(okp, top, 0)].reshape(nq, -1)
        cvalid = (cand >= 0) & okp.repeat_interleave(m0, dim=1)
        ctiles = torch.where(cvalid, cand // b, -1)
        fresh = dedupe_first(ctiles, cvalid)
        fresh &= ~(ctiles[:, :, None] == hist[:, None, :]).any(2)
        # the first F fresh tiles in parent-rank order
        forder = torch.sort((~fresh).to(torch.uint8), dim=1,
                            stable=True)[1][:, :F]
        sel_f = torch.gather(fresh, 1, forder)
        probes = torch.where(sel_f, torch.gather(ctiles, 1, forder), -1)
        probes = probes.to(torch.int32)
        hist = torch.cat([hist, probes], 1)
        hd, hpos, _ = _scan_tiles(xq, probes, ftg, min(rk, F * kp), metric,
                                  kp)
        bd, bpos = TK.merge_topk(bd, bpos, hd, hpos, rk,
                                 similarity=similarity)
    out_d, out_p = bd[:, :k], bpos[:, :k]
    out_i = torch.where(out_p >= 0, ftg.orig_ids[out_p.clamp(min=0)].long(),
                        -1)
    return out_d, out_p, out_i
