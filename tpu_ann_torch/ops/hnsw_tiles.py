"""Tile-granular HNSW traversal — PyTorch counterpart of
`tpu_ann/ops/hnsw_tiles.py`.

The reference's level-0 search pops one node at a time and reads its
neighbours' vectors one by one. Here the vectors are stored in SPATIAL
ORDER (k-means cells of about a tile) in fixed tiles of ``b`` consecutive
positions, so "visit a node" becomes "scan its whole tile". Three
traversals share that layout:

* the tile beam (`TileGraph`, `tile_search`; reference :80-333, 681): the
  per-node beam's algorithm and stop rule with tile-granular scans — each
  hop expands the best ``expand`` unexpanded VECTORS (exact distances),
  maps their neighbours to tiles and scores up to ``scan_tiles`` tiles not
  visited yet with one bf16 product (f32 accumulation); the visited set is
  one bool a tile; entry tiles come from a top-S centroid kNN; an optional
  exact f32 re-score of the ef candidates ends it. Plain torch, as the
  reference's is XLA;
* the fused tiles (`FusedTileGraph`, `tile_search_fused`; reference :337,
  447): tiles as packed invlists scanned by the list-major fused scan
  (K3, `ivf_scan_fused.scan_invlists_fused`, or K3-SQ8 on SQ8 tiles),
  which re-ranks in exact f32. Hop 0 routes each query to its top-nprobe0
  tiles by one product over the tile centroids (the role of the upper
  levels); each graph hop expands the best ``expand`` positions through
  the level-0 adjacency and scans the first F tiles not scanned yet (in
  parent-rank order). So a search is 1 + hops launches; each keeps the
  exact top-kp of every (query, tile) inside the kernel, at any kp;
* the PQ tiles (`PQTileGraph`, `tile_search_pq`; reference :528-678): the
  fused route's control flow over PQ code tiles, each scan the ADC table
  scan `ivf_scan.scan_invlists_pq` (plain torch, as the reference's is
  XLA).

All internal scores are CANONICAL (ascending-best, inner product negated);
public entry points flip similarities back. Every sort is stable, so the
lower index wins a tie, as ``lax.top_k`` and ``jnp.argsort`` do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import distances as D
from . import topk as TK
from .hnsw import CHECK_EVERY, dedupe_first
from .ivf_scan import (PackedCodeInvLists, PackedInvLists, pack_code_invlists,
                       pack_invlists, scan_invlists_pq)
from .ivf_scan_fused import scan_invlists_fused
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


def _layout(x: np.ndarray, neighbors0, order, b: int):
    """The host arrays every tile layout shares (reference :131-162): the
    order, the tile count T, the rows in position order zero-padded to
    T * b, the (T * b, M0) neighbour positions and the position -> node id
    map (-1 padded)."""
    x = np.ascontiguousarray(np.asarray(x), np.float32)
    n, d = x.shape
    order = np.arange(n, dtype=np.int64) if order is None else \
        np.asarray(order, np.int64)
    pos_of = np.empty(n, np.int64)
    pos_of[order] = np.arange(n)
    T = max(-(-n // b), 1)
    xs = np.zeros((T * b, d), np.float32)
    xs[:n] = x[order]
    nb = np.asarray(torch.as_tensor(neighbors0).cpu(), np.int64)
    nbr = np.full((T * b, nb.shape[1]), -1, np.int32)
    ok = nb >= 0
    nbr[:n] = np.where(ok, pos_of[np.where(ok, nb, 0)], -1)[order]
    orig_ids = np.full(T * b, -1, np.int32)
    orig_ids[:n] = order
    return order, T, xs, nbr, orig_ids


def _tile_counts(n: int, T: int, b: int) -> np.ndarray:
    cnt = np.full(T, b, np.float32)
    cnt[-1] = b - (T * b - n)
    return cnt


def _centroids64(xs: np.ndarray, n: int, T: int, b: int) -> np.ndarray:
    """Tile centroids summed in float64 (reference :395-404, 578-588)."""
    d = xs.shape[1]
    return (xs.reshape(T, b, d).sum(axis=1, dtype=np.float64)
            / np.maximum(_tile_counts(n, T, b), 1.0)[:, None]
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# the tile beam (reference :78-333, 681-746)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TileGraph:
    """Tiled bf16 storage and the position-space level-0 adjacency of the
    tile beam (reference :80). Positions are the spatially reordered rows;
    ``orig_ids`` maps them back to node ids."""

    vtiles: torch.Tensor     # (T, b, d) bf16 rows in position order
    vnorms: torch.Tensor     # (T, b) f32 squared norms (inf on padding)
    nbr_pos: torch.Tensor    # (T*b, M0) int32 neighbour POSITIONS (-1 pad)
    cent: torch.Tensor       # (T, d) f32 tile centroids (entry seeding)
    orig_ids: torch.Tensor   # (T*b,) int32 position -> node id (-1 pad)
    n: int = 0

    @property
    def ntiles(self) -> int:
        return self.vtiles.shape[0]

    @property
    def b(self) -> int:
        return self.vtiles.shape[1]

    def device_bytes(self) -> int:
        return sum(t.nbytes for t in (self.vtiles, self.vnorms, self.nbr_pos,
                                      self.cent, self.orig_ids))


def build_tiles(x: np.ndarray, neighbors0, *,
                order: Optional[np.ndarray] = None, b: int = 32,
                device="cuda") -> TileGraph:
    """The tile beam's layout from vectors (node-id order) and the level-0
    graph (reference :116): the reference's arrays byte for byte (norms
    summed in float64, centroids in float32 as it sums them)."""
    order, T, xs, nbr, orig_ids = _layout(x, neighbors0, order, b)
    n, d = len(order), xs.shape[1]
    vnorms = (xs.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    vnorms[n:] = np.inf
    vtiles = xs.reshape(T, b, d)
    cent = (vtiles.sum(axis=1) / np.maximum(_tile_counts(n, T, b)[:, None],
                                            1.0)).astype(np.float32)
    return TileGraph(
        vtiles=torch.from_numpy(vtiles).to(device).to(torch.bfloat16),
        vnorms=torch.from_numpy(vnorms.reshape(T, b)).to(device),
        nbr_pos=torch.from_numpy(nbr).to(device),
        cent=torch.from_numpy(cent).to(device),
        orig_ids=torch.from_numpy(orig_ids).to(device), n=n)


def _visited_test(visited: torch.Tensor, ids: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """valid & not visited & first occurrence in the row (reference :181).
    ``visited`` is a bool (nq, T + 1) table, one entry a tile (the
    reference's uint32 bitset marks the same tiles)."""
    seen = torch.gather(visited, 1, torch.where(valid, ids, 0).long())
    return dedupe_first(ids, valid) & ~seen


def _visited_set(visited: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> None:
    """Mark the masked tiles (column T takes the others' writes)."""
    visited.scatter_(1, torch.where(mask, ids.long(),
                                    visited.shape[1] - 1), True)


def _scan_tiles(tg: TileGraph, xqb: torch.Tensor, qn: torch.Tensor,
                tids: torch.Tensor, tvalid: torch.Tensor, similarity: bool):
    """Score every member of the selected tiles (reference :210): bf16
    queries times bf16 rows, summed in f32; L2 qn + norm - 2 q.x (no clamp,
    as the reference's). tids / tvalid (nq, F). Returns (scores (nq, F*b)
    canonical, positions (nq, F*b) int32, rows scored)."""
    nq, F = tids.shape
    b, d = tg.vtiles.shape[1:]
    safe = torch.where(tvalid, tids, 0).long()
    tiles = tg.vtiles[safe].float()                        # (nq, F, b, d)
    ip = torch.bmm(tiles.view(nq, F * b, d),
                   xqb.float()[:, :, None]).view(nq, F, b)
    sc = -ip if similarity else qn[:, None, None] + tg.vnorms[safe] - 2.0 * ip
    pos = safe[:, :, None] * b + torch.arange(b, device=safe.device)
    valid = (pos < tg.n) & tvalid[:, :, None]
    sc = torch.where(valid, sc, float("inf")).view(nq, F * b)
    pos = torch.where(valid, pos, -1).view(nq, F * b).to(torch.int32)
    return sc, pos, valid.sum()


def _stable_sort(v: torch.Tensor):
    return torch.sort(v, dim=1, stable=True)


def tile_beam(tg: TileGraph, xq: torch.Tensor, seed_tiles: torch.Tensor, *,
              ef: int, expand: int, scan_tiles: int, max_hops: int,
              metric: int, stop_frac: float):
    """Lockstep best-first beam with vector-precision routing and
    tile-granular scans (reference :238). A query stops when its best
    unexpanded vector is worse than its ef-th result plus stop_frac of it,
    or has none. The reference's ``lax.while_loop`` ends when every query
    stopped or at max_hops; a stopped query changes nothing afterwards, so
    this loop tests ``done.all()`` (a host sync) only every CHECK_EVERY
    hops, as the per-node beam does: the result is that of a test every
    hop, or of none. Returns (scores (nq, ef) canonical ascending, positions
    (nq, ef) int32, {nhops, ndis})."""
    nq = xq.shape[0]
    T = tg.ntiles
    m0 = tg.nbr_pos.shape[1]
    dev = xq.device
    similarity = D.is_similarity_metric(metric)
    inf = float("inf")
    xq = xq.float()
    xqb = xq.to(torch.bfloat16)
    qn = (xq * xq).sum(1)
    seed_tiles = seed_tiles.to(torch.int32)
    visited = torch.zeros((nq, T + 1), dtype=torch.bool, device=dev)
    sfresh = _visited_test(visited, seed_tiles, seed_tiles >= 0)
    _visited_set(visited, seed_tiles, sfresh)
    sc, pos, ndis = _scan_tiles(tg, xqb, qn, seed_tiles, sfresh, similarity)
    if sc.shape[1] < ef:
        pad = ef - sc.shape[1]
        sc = torch.cat([sc, sc.new_full((nq, pad), inf)], 1)
        pos = torch.cat([pos, pos.new_full((nq, pad), -1)], 1)
    bd, order = _stable_sort(sc)
    bd, bi = bd[:, :ef], torch.gather(pos, 1, order[:, :ef])
    bexp = ~torch.isfinite(bd)
    done = torch.zeros(nq, dtype=torch.bool, device=dev)
    hops = torch.zeros((), dtype=torch.long, device=dev)
    for it in range(max_hops):
        if it and it % CHECK_EVERY == 0 and bool(done.all()):
            break
        hops += (~done).any().long()
        # 1) the best unexpanded vectors (exact distances)
        sel_d, ppos = _stable_sort(torch.where(bexp, inf, bd))
        sel_d, ppos = sel_d[:, :expand], ppos[:, :expand]
        sel_ok = torch.isfinite(sel_d)
        # 2) stop rule: check_relative_distance (HNSW.cpp:645) + slack
        thresh = bd[:, ef - 1]
        newly_done = ~sel_ok[:, 0] | \
            (sel_d[:, 0] > thresh + stop_frac * thresh.abs())
        do_exp = sel_ok & ~done[:, None]
        bexp = bexp.scatter(1, ppos, torch.gather(bexp, 1, ppos) | do_exp)
        # 3) neighbour rows -> candidate tiles
        sel_pos = torch.where(do_exp, torch.gather(bi, 1, ppos), 0)
        rows = tg.nbr_pos[sel_pos.long()].view(nq, expand * m0)
        nvalid = (rows >= 0) & do_exp.repeat_interleave(m0, dim=1)
        tids = torch.where(nvalid, rows // tg.b, 0)
        fresh = _visited_test(visited, tids, nvalid)
        # 4) the first scan_tiles fresh tiles in parent-rank order; the
        # others stay unvisited and can be found again
        forder = _stable_sort((~fresh).to(torch.uint8))[1][:, :scan_tiles]
        sel_t = torch.gather(tids, 1, forder)
        sel_f = torch.gather(fresh, 1, forder)
        _visited_set(visited, sel_t, sel_f)
        # 5) scan, 6) merge into the ef buffer
        sc, pos, ns = _scan_tiles(tg, xqb, qn, sel_t, sel_f, similarity)
        ndis += ns
        md, mo = _stable_sort(torch.cat([bd, sc], 1))
        mo = mo[:, :ef]
        bd = md[:, :ef]
        bi = torch.gather(torch.cat([bi, pos], 1), 1, mo)
        bexp = torch.gather(torch.cat([bexp, ~torch.isfinite(sc)], 1), 1, mo)
        done = done | newly_done
    return bd, bi, {"nhops": hops, "ndis": ndis}


def tile_search(tg: TileGraph, xq: torch.Tensor, k: int, *, ef: int = 0,
                expand: int = 4, scan_tiles: int = 0, max_hops: int = 0,
                seed_count: int = 0, metric: int = D.METRIC_L2,
                stop_frac: float = 0.15,
                refine_vectors: Optional[torch.Tensor] = None):
    """Search the tile graph with the tile beam (reference :681). ``ef``
    sizes the buffer (efSearch's role, at least k); ``expand`` vectors are
    expanded a hop; up to ``scan_tiles`` (0: 2 expand) fresh tiles are
    scanned a hop; ``seed_count`` (0: max(2 expand, 8)) entry tiles come
    from a bf16 centroid kNN; max_hops 0 is max(12, ef / expand + 12).
    ``refine_vectors`` (node-id order) re-scores the ef candidates in exact
    f32 before the top-k. Returns (dists (nq, k) user-facing, ids (nq, k)
    int64 node ids, -1 for empty slots, stats {nhops, ndis})."""
    similarity = D.is_similarity_metric(metric)
    ef = max(ef, k)
    T = tg.ntiles
    expand = max(1, expand)
    scan_tiles = min(scan_tiles if scan_tiles > 0 else 2 * expand, T)
    if seed_count <= 0:
        seed_count = min(max(2 * expand, 8), T)
    if max_hops <= 0:
        max_hops = max(12, ef // expand + 12)
    xq = xq.float()
    _, sids = D.knn(xq, tg.cent, seed_count, metric,
                    compute_dtype="bfloat16", approx=T > 4096)
    rd, ri, stats = tile_beam(tg, xq, sids, ef=ef, expand=expand,
                              scan_tiles=scan_tiles, max_hops=max_hops,
                              metric=metric, stop_frac=float(stop_frac))
    ids = torch.where(ri >= 0, tg.orig_ids[ri.long().clamp(min=0)], -1).long()
    if refine_vectors is not None:
        vecs = refine_vectors[ids.clamp(min=0)].float()
        ip = torch.bmm(vecs, xq[:, :, None])[:, :, 0]
        if similarity:
            sc = -ip
        else:
            sc = torch.clamp((xq * xq).sum(1, keepdim=True)
                             + (vecs * vecs).sum(2) - 2.0 * ip, min=0.0)
        sc = torch.where(ids >= 0, sc, float("inf"))
        out_d, pos = _stable_sort(sc)
        out_d, out_i = out_d[:, :k], torch.gather(ids, 1, pos[:, :k])
    else:
        out_d, out_i = rd[:, :k], ids[:, :k]
    if similarity:
        out_d = -out_d
    return out_d, out_i, stats


# ---------------------------------------------------------------------------
# the fused tiles (reference :335-523)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedTileGraph:
    """Tiles as packed invlists (list i = tile i = positions [i*b, i*b +
    b)): a `PackedInvLists` (f32, bf16 or fp16 rows for the exact re-rank,
    the bf16 stream K3 reads) or a `PackedInvListsSQ8` (uint8 codes for
    K3-SQ8), the tile centroids for hop-0 routing and the position-space
    level-0 adjacency (reference :337)."""

    il: object
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
    order, T, xs, nbr, orig_ids = _layout(x, neighbors0, order, b)
    n = len(order)
    il = pack_invlists(xs[:n], np.arange(n, dtype=np.int64),
                       np.arange(n, dtype=np.int64) // b, T, block_size=b,
                       device=device)
    return FusedTileGraph(il=il,
                          cent=torch.from_numpy(
                              _centroids64(xs, n, T, b)).to(device),
                          nbr_pos=torch.from_numpy(nbr).to(device),
                          orig_ids=torch.from_numpy(orig_ids).to(device),
                          b=b, n=n)


def _hop_tiles(bpos: torch.Tensor, nbr_pos: torch.Tensor, hist: torch.Tensor,
               expand: int, F: int, b: int):
    """One graph hop's tiles (reference :495-511, 653-665): the tiles of
    the neighbours of the best ``expand`` positions, deduplicated and not
    in ``hist`` (the tiles scanned so far), the first F in parent-rank
    order. Returns (tiles (nq, F), fresh mask (nq, F))."""
    nq = bpos.shape[0]
    top = bpos[:, :expand]
    okp = top >= 0
    cand = nbr_pos[torch.where(okp, top, 0).long()].flatten(1)
    cvalid = (cand >= 0) & okp.repeat_interleave(nbr_pos.shape[1], dim=1)
    ctiles = torch.where(cvalid, cand // b, -1)
    fresh = dedupe_first(ctiles, cvalid)
    fresh &= ~(ctiles[:, :, None] == hist[:, None, :]).any(2)
    forder = _stable_sort((~fresh).to(torch.uint8))[1][:, :F]
    return torch.gather(ctiles, 1, forder), torch.gather(fresh, 1, forder)


def tile_search_fused(ftg: FusedTileGraph, xq: torch.Tensor, k: int, *,
                      nprobe0: int = 16, hops: int = 2, expand: int = 8,
                      F: int = 8, kp: int = 8, rk: int = 32,
                      metric: int = D.METRIC_L2):
    """Graph-accelerated tile search on the fused scan (reference :447; see
    the module docstring). Every scan keeps the top kp of each (query,
    tile) and re-ranks the top 4 x its width in exact f32.
    Returns (dists (nq, k) user-facing, positions (nq, k), ids (nq, k)
    int64 node ids, -1 for empty slots)."""
    similarity = D.is_similarity_metric(metric)
    b = ftg.b
    T = ftg.il.nlist
    xq = xq.float()
    _, seeds = D.knn(xq, ftg.cent, min(nprobe0, T), metric,
                     compute_dtype="bfloat16", approx=T > 4096)
    seeds = seeds.to(torch.int32)
    bd, bpos, _ = scan_invlists_fused(xq, seeds, ftg.il, min(rk, nprobe0 * kp),
                                      metric, kp=kp, refine=4)
    # positions come back through the ids channel (ids == positions)
    hist = seeds
    for _ in range(hops):
        sel_t, sel_f = _hop_tiles(bpos, ftg.nbr_pos, hist, expand, F, b)
        probes = torch.where(sel_f, sel_t, -1).to(torch.int32)
        hist = torch.cat([hist, probes], 1)
        hd, hpos, _ = scan_invlists_fused(xq, probes, ftg.il, min(rk, F * kp),
                                          metric, kp=kp, refine=4)
        bd, bpos = TK.merge_topk(bd, bpos, hd, hpos, rk,
                                 similarity=similarity)
    out_d, out_p = bd[:, :k], bpos[:, :k]
    out_i = torch.where(out_p >= 0, ftg.orig_ids[out_p.clamp(min=0)].long(),
                        -1)
    return out_d, out_p, out_i


# ---------------------------------------------------------------------------
# the PQ tiles (reference :526-678)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PQTileGraph:
    """Tiles of PQ codes (IndexHNSWPQ's memory model: M bytes a vector):
    T + 1 code lists, the last one EMPTY (the target of a hop's invalid
    probes), the tile centroids of the raw rows, the position-space
    adjacency and the PQ codebook (reference :528)."""

    il: PackedCodeInvLists
    cent: torch.Tensor          # (T, d) f32 tile centroids (raw rows)
    nbr_pos: torch.Tensor       # (T*b, M0) int32 neighbour POSITIONS
    orig_ids: torch.Tensor      # (T*b,) int32 position -> node id
    pq_centroids: torch.Tensor  # (M, ksub, dsub) f32
    b: int = 128
    n: int = 0


def build_tiles_pq(x: Optional[np.ndarray], codes, pq_centroids, neighbors0,
                   *, order: Optional[np.ndarray] = None, b: int = 128,
                   cent: Optional[np.ndarray] = None,
                   device="cuda") -> PQTileGraph:
    """PQTileGraph from the raw rows (only for the tile centroids; not
    stored), their codes (n, M) and the level-0 graph (reference :549).
    ``cent`` (T, d), if given, replaces the centroids of ``x`` (then x may
    be None: a reopened index whose raw rows are gone)."""
    codes = codes.to(device) if isinstance(codes, torch.Tensor) else \
        torch.tensor(np.asarray(codes), device=device)
    n = codes.shape[0]
    rows = np.zeros((n, 1), np.float32) if x is None else x
    order, T, xs, nbr, orig_ids = _layout(rows, neighbors0, order, b)
    if cent is None:
        cent = _centroids64(xs, n, T, b)
    il = pack_code_invlists(codes[torch.from_numpy(order).to(device)],
                            np.arange(n, dtype=np.int64),
                            np.arange(n, dtype=np.int64) // b, T + 1,
                            block_size=b, device=device)
    return PQTileGraph(
        il=il, cent=torch.as_tensor(np.asarray(cent, np.float32)).to(device),
        nbr_pos=torch.from_numpy(nbr).to(device),
        orig_ids=torch.from_numpy(orig_ids).to(device),
        pq_centroids=torch.as_tensor(np.asarray(pq_centroids, np.float32)
                                     ).to(device), b=b, n=n)


def tile_search_pq(ptg: PQTileGraph, xq: torch.Tensor, k: int, *,
                   nprobe0: int = 16, hops: int = 2, expand: int = 8,
                   F: int = 4, rk: int = 32, metric: int = D.METRIC_L2):
    """`tile_search_fused`'s control flow over PQ code tiles (reference
    :614): hop-0 centroid route, ADC scans (`scan_invlists_pq`,
    by_residual=False: one table a query), graph hops through the level-0
    adjacency. Distances are the codec's ADC distances, as the reference's
    IndexHNSWPQ returns. Returns (dists (nq, k) user-facing, positions
    (nq, k), ids (nq, k) int64, -1 for empty slots)."""
    similarity = D.is_similarity_metric(metric)
    b = ptg.b
    T = ptg.il.nlist - 1          # the last list is the empty target
    xq = xq.float()

    def scan(probes):
        return scan_invlists_pq(xq, probes, ptg.il, ptg.pq_centroids, None,
                                min(rk, probes.shape[1] * b), metric,
                                by_residual=False, max_nblocks=1)

    _, seeds = D.knn(xq, ptg.cent, min(nprobe0, T), metric,
                     compute_dtype="bfloat16", approx=T > 4096)
    seeds = seeds.to(torch.int32)
    bd, bpos, _ = scan(seeds)
    hist = seeds
    for _ in range(hops):
        sel_t, sel_f = _hop_tiles(bpos, ptg.nbr_pos, hist, expand, F, b)
        hd, hpos, _ = scan(torch.where(sel_f, sel_t, T).to(torch.int32))
        hist = torch.cat([hist, torch.where(sel_f, sel_t, -1).to(
            torch.int32)], 1)
        bd, bpos = TK.merge_topk(bd, bpos, hd, hpos, rk,
                                 similarity=similarity)
    out_d, out_p = bd[:, :k], bpos[:, :k]
    out_i = torch.where(out_p >= 0, ptg.orig_ids[out_p.long().clamp(min=0)]
                        .long(), -1)
    return out_d, out_p, out_i
