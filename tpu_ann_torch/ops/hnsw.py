"""HNSW as batched frontier expansion — PyTorch counterpart of
`tpu_ann/ops/hnsw.py` (faiss `impl/HNSW.{h,cpp}`).

The graph is kept as flat fixed-degree tables (faiss/impl/HNSW.h:109-128):
level 0 of degree 2M for every node, and per-level rows of degree M for the
nodes of level >= 1, compacted into `upper_ids` (sorted).

Search: greedy descent through the upper levels (HNSW.cpp:852-925), then a
lockstep best-first beam at level 0 (`search_from_candidates`,
HNSW.cpp:605-741) for all queries at once: each hop expands the best
`expand` unexpanded buffer entries, filters their neighbours through a
visited table, scores the fresh ones and sort-merges them into an ef-wide
buffer; a query stops on the reference's `check_relative_distance` rule.
The reference's `lax.while_loop`s are bounded Python loops here that test
for termination every few hops (each test is a host sync); hops run after
every query stopped change nothing. The visited set is a boolean
(nq, n) table per search call instead of the reference's uint32 bitset
(torch has no bitwise-or scatter); both mark the same nodes.

Build, two ways:
* `build_graph_knn` (reference :947): the batch kNN graph — kNN
  candidates (exact blocked product for n <= 32768, else k-means probes
  and the query-major `ivf_scan.scan_invlists`), forward links, capped
  reverse edges, one diversity prune (`shrink_neighbor_list`,
  HNSW.cpp:245-299) of forward and reverse candidates, and the upper
  levels linked by exact kNN within each level's node subset;
* `build_graph` (reference :526), wave insertion: points bucketed by level
  high to low (`hnsw_add_vertices`, IndexHNSW.cpp:68-224), each bucket in
  waves that beam-search the pre-wave graph, keep forward links by the
  diversity heuristic and add reverse links, pruning an overflowing list
  with the heuristic again (`add_link`, HNSW.cpp:501-537).
  `extend_graph` (reference :1112) wave-inserts added rows into an
  existing level 0 and relinks the upper levels. The reference pads every
  wave to one static size so that XLA compiles once; here a wave is its
  own size, which changes no link.

All internal scores are CANONICAL: ascending-best for every metric, inner
product negated. Public entry points flip similarities back. Every sort is
stable, as `jnp.argsort` is.

This module has no hand-written kernel: the reference reaches no Pallas
kernel on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import distances as D
from . import ivf_scan as IV
from .kmeans import ClusteringParameters, kmeans

# hops between the beam loops' termination tests (each one a host sync)
CHECK_EVERY = 4


@dataclasses.dataclass
class HNSWGraph:
    """Flat fixed-degree multilevel graph (device tensors, -1 padded).
    Nodes with level >= 1 are compacted into `upper_ids` (sorted) with
    their per-level rows in `upper_neighbors[row, l - 1]`."""

    neighbors0: torch.Tensor       # (N, M0) int32, level-0 links
    upper_ids: torch.Tensor        # (U,) int32 sorted; U >= 1 (padded)
    upper_neighbors: torch.Tensor  # (U, Lmax, M) int32, global ids
    levels: torch.Tensor           # (N,) int32 max level per node
    entry: int = 0                 # entry point id
    max_level: int = 0

    @property
    def n(self) -> int:
        return self.neighbors0.shape[0]

    @property
    def m0(self) -> int:
        return self.neighbors0.shape[1]

    @property
    def m(self) -> int:
        return self.upper_neighbors.shape[2]


def random_levels(n: int, m: int, seed: int = 1234,
                  offset: int = 0) -> np.ndarray:
    """Per-node max levels: geometric with mult = 1/ln(M) (faiss
    HNSW::random_level / set_default_probas); the reference's draws."""
    rs = np.random.RandomState(seed + offset)
    u = rs.rand(n)
    mult = 1.0 / np.log(max(m, 2))
    return np.floor(-np.log(np.maximum(u, 1e-12)) * mult).astype(np.int32)


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

_SENTINEL = 2 ** 30


def dedupe_first(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """valid & first occurrence of each id within its row (later equal
    entries masked), the reference's sort-based in-batch dedupe."""
    key = torch.where(valid, ids.long(), _SENTINEL)
    s, order = torch.sort(key, dim=1, stable=True)
    dup_sorted = torch.cat([torch.zeros_like(s[:, :1], dtype=torch.bool),
                            s[:, 1:] == s[:, :-1]], 1)
    dup = torch.empty_like(dup_sorted).scatter_(1, order, dup_sorted)
    return valid & ~dup


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, idx)


def batch_dists(xq: torch.Tensor, vecs: torch.Tensor,
                metric: int = D.METRIC_L2) -> torch.Tensor:
    """(nq, d) x (nq, c, d) -> (nq, c) canonical scores in f32: -q.x for
    IP, max(||q||^2 + ||x||^2 - 2 q.x, 0) for L2."""
    xq = xq.float()
    vecs = vecs.float()
    ip = torch.bmm(vecs, xq[:, :, None])[:, :, 0]
    if D.is_similarity_metric(metric):
        return -ip
    qn = (xq * xq).sum(1, keepdim=True)
    return torch.clamp(qn + (vecs * vecs).sum(2) - 2.0 * ip, min=0.0)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _upper_rows(graph: HNSWGraph, node: torch.Tensor) -> torch.Tensor:
    return torch.searchsorted(graph.upper_ids, node.to(graph.upper_ids.dtype))


def greedy_level(vectors, graph: HNSWGraph, xq, level: int, cur, cur_d,
                 max_hops: int = 64, metric: int = D.METRIC_L2):
    """Batched greedy walk at ``level`` (>= 1), reference :159: move to the
    nearest neighbour until no query improves. cur / cur_d: (nq,) node and
    canonical distance."""
    improved = torch.ones(cur.shape[0], dtype=torch.bool, device=cur.device)
    for hop in range(max_hops):
        if hop and hop % CHECK_EVERY == 0 and not bool(improved.any()):
            break
        nbrs = graph.upper_neighbors[_upper_rows(graph, cur), level - 1]
        valid = nbrs >= 0
        vecs = vectors[torch.where(valid, nbrs, 0).long()]
        dis = torch.where(valid, batch_dists(xq, vecs, metric), float("inf"))
        best, arg = dis.min(1)
        move = (best < cur_d) & improved
        cur = torch.where(move, _take(nbrs, arg[:, None])[:, 0], cur)
        cur_d = torch.where(move, best, cur_d)
        improved = move
    return cur, cur_d


def beam_search_level0(vectors: torch.Tensor, neighbors0: torch.Tensor,
                       xq: torch.Tensor, entry_ids: torch.Tensor, *,
                       ef: int, k: int, expand: int = 2, max_hops: int = 0,
                       metric: int = D.METRIC_L2, raw: bool = False):
    """Bounded best-first search over the level-0 graph, all queries in
    lockstep (reference :216). entry_ids: (nq, E) starting points (-1
    padded). Returns (dists (nq, k), ids (nq, k) int32, stats {nhops,
    ndis}); distances user-facing unless ``raw``."""
    nq = xq.shape[0]
    n, m0 = neighbors0.shape
    dev = xq.device
    xq = xq.float()
    if max_hops <= 0:
        max_hops = 2 * ef // max(expand, 1) + 16
    B = ef
    inf = float("inf")
    entry_ids = entry_ids.to(torch.int32)

    # column n takes the writes of the entries that mark nothing
    visited = torch.zeros((nq, n + 1), dtype=torch.bool, device=dev)
    e_valid = entry_ids >= 0
    fresh = dedupe_first(entry_ids, e_valid)
    visited.scatter_(1, torch.where(fresh, entry_ids, n).long(), True)
    e_vecs = vectors[torch.where(e_valid, entry_ids, 0).long()]
    e_dis = torch.where(fresh, batch_dists(xq, e_vecs, metric), inf)
    pad = max(B - entry_ids.shape[1], 0)
    bd = torch.cat([e_dis, e_dis.new_full((nq, pad), inf)], 1)
    bi = torch.cat([torch.where(fresh, entry_ids, -1),
                    entry_ids.new_full((nq, pad), -1)], 1)
    bexp = bd == inf                          # padding counts as expanded
    bd, order = torch.sort(bd, dim=1, stable=True)
    bd, order = bd[:, :B], order[:, :B]
    bi, bexp = _take(bi, order), _take(bexp, order)

    done = torch.zeros(nq, dtype=torch.bool, device=dev)
    hops = torch.zeros((), dtype=torch.long, device=dev)
    ndis = torch.zeros((), dtype=torch.long, device=dev)
    for it in range(max_hops):
        if it and it % CHECK_EVERY == 0 and bool(done.all()):
            break
        hops += (~done).any().long()
        # 1) the best `expand` unexpanded entries
        sel_d, pos = torch.sort(torch.where(bexp, inf, bd), dim=1,
                                stable=True)
        sel_d, pos = sel_d[:, :expand], pos[:, :expand]
        sel_ok = torch.isfinite(sel_d)
        # stop rule (check_relative_distance, HNSW.cpp:645)
        newly_done = ~sel_ok[:, 0] | (sel_d[:, 0] > bd[:, B - 1])
        do_expand = sel_ok & ~done[:, None]
        # 2) mark them expanded, 3) gather their neighbours
        bexp = bexp.scatter(1, pos, _take(bexp, pos) | do_expand)
        src = torch.where(do_expand, _take(bi, pos), 0).long()
        nbrs = neighbors0[src].reshape(nq, expand * m0)
        valid = (nbrs >= 0) & do_expand.repeat_interleave(m0, dim=1)
        # 4) visited filter + mark
        safe = torch.where(valid, nbrs, 0).long()
        fresh = dedupe_first(nbrs, valid) & ~torch.gather(visited, 1, safe)
        visited.scatter_(1, torch.where(fresh, safe, n), True)
        # 5) distances
        vecs = vectors[torch.where(fresh, nbrs, 0).long()]
        dis = torch.where(fresh, batch_dists(xq, vecs, metric), inf)
        ndis += fresh.sum()
        # 6) sort-merge into the buffer
        cd = torch.cat([bd, dis], 1)
        ci = torch.cat([bi, torch.where(fresh, nbrs, -1)], 1)
        ce = torch.cat([bexp, ~fresh], 1)
        cd, mo = torch.sort(cd, dim=1, stable=True)
        mo = mo[:, :B]
        bd, bi, bexp = cd[:, :B], _take(ci, mo), _take(ce, mo)
        done = done | newly_done
    out_d = bd[:, :k]
    if D.is_similarity_metric(metric) and not raw:
        out_d = -out_d
    return out_d, bi[:, :k], {"nhops": hops, "ndis": ndis}


def hnsw_search(vectors: torch.Tensor, graph: HNSWGraph, xq: torch.Tensor,
                *, ef: int, k: int, expand: int = 2,
                metric: int = D.METRIC_L2):
    """Full HNSW search (HNSW::search, HNSW.cpp:943-1000): greedy descent
    through the upper levels, then the level-0 beam (reference :331)."""
    nq = xq.shape[0]
    xq = xq.float()
    cur = torch.full((nq,), int(graph.entry), dtype=torch.int32,
                     device=xq.device)
    cur_d = batch_dists(xq, vectors[cur.long()][:, None, :], metric)[:, 0]
    for level in range(graph.max_level, 0, -1):
        cur, cur_d = greedy_level(vectors, graph, xq, level, cur, cur_d,
                                  metric=metric)
    return beam_search_level0(vectors, graph.neighbors0, xq, cur[:, None],
                              ef=ef, k=k, expand=expand, metric=metric)


# ---------------------------------------------------------------------------
# the diversity heuristic (shrink_neighbor_list, HNSW.cpp:245-299)
# ---------------------------------------------------------------------------

def select_neighbors_heuristic(cand_ids: torch.Tensor, cand_dis: torch.Tensor,
                               vectors: torch.Tensor, m: int,
                               metric: int = D.METRIC_L2):
    """For each row: scan its candidates in distance order and keep c only
    if dist(q, c) < dist(c, kept) for every kept candidate, up to m
    (reference :363). cand_dis is canonical. The pairwise scores are what
    the reference's jitted program computes: f32 products of the (possibly
    bf16) vectors' values, each norm rounded to the vectors' type, their
    sum and difference in f32.
    Returns (ids (W, m) int32 -1 padded, dis (W, m) f32 inf padded)."""
    W, C = cand_ids.shape
    cand_dis, order = torch.sort(cand_dis, dim=1, stable=True)
    cand_ids = _take(cand_ids, order)
    valid = cand_ids >= 0
    cv = vectors[torch.where(valid, cand_ids, 0).long()]     # (W, C, d)
    cvf = cv.float()
    ip = torch.bmm(cvf, cvf.transpose(1, 2))
    if D.is_similarity_metric(metric):
        pair = -ip
    else:
        nrm = (cvf * cvf).sum(2).to(vectors.dtype).float()
        pair = torch.clamp(nrm[:, :, None] + nrm[:, None, :] - 2.0 * ip,
                           min=0.0)
    kept = torch.zeros((W, C), dtype=torch.bool, device=cand_ids.device)
    nkept = torch.zeros(W, dtype=torch.long, device=cand_ids.device)
    for i in range(C):
        conflict = (kept & (pair[:, i, :] < cand_dis[:, i:i + 1])).any(1)
        take = valid[:, i] & ~conflict & (nkept < m)
        kept[:, i] = take
        nkept += take.long()
    score = torch.where(kept, cand_dis, float("inf"))
    t = min(m, C)
    score, so = torch.sort(score, dim=1, stable=True)
    so = so[:, :t]
    out = _take(torch.where(kept, cand_ids, -1), so).to(torch.int32)
    out_d = score[:, :t]
    if t < m:
        out = torch.cat([out, out.new_full((W, m - t), -1)], 1)
        out_d = torch.cat([out_d, out_d.new_full((W, m - t), float("inf"))],
                          1)
    return out, out_d


def prune_all(vectors, cand_ids, cand_dis, m: int, metric: int,
              chunk: int = 65536):
    """`select_neighbors_heuristic` over every row, in row chunks
    (reference :794). Returns (ids (n, m) int32, dis (n, m) f32)."""
    outs = [select_neighbors_heuristic(cand_ids[i:i + chunk],
                                       cand_dis[i:i + chunk], vectors, m,
                                       metric)
            for i in range(0, cand_ids.shape[0], chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


# ---------------------------------------------------------------------------
# wave insertion (reference :420-680)
# ---------------------------------------------------------------------------

def apply_reverse_links(vectors: torch.Tensor, neighbors_l: torch.Tensor,
                        fwd_ids: torch.Tensor, wave_ids: torch.Tensor,
                        metric: int = D.METRIC_L2) -> torch.Tensor:
    """Add the reverse edges target <- wave point of every forward link,
    each touched target's list pruned back to its degree with the diversity
    heuristic (reference :424). A target takes at most min(deg, 16) new
    sources, the first in wave order. ``neighbors_l`` (N, deg) is updated
    in place and returned; ``fwd_ids`` (W, m) are -1 padded."""
    N, deg = neighbors_l.shape
    W, m = fwd_ids.shape
    R = W * m
    dev = neighbors_l.device
    if R == 0:
        return neighbors_l
    tgt = fwd_ids.reshape(R).long()
    src = wave_ids.long().repeat_interleave(m)
    tgt_s, order = torch.sort(torch.where(tgt >= 0, tgt, N), stable=True)
    src_s = src[order]
    # one row per distinct valid target: the first of its run (the
    # reference computes every request row; the rows of one run are equal)
    head = torch.ones(R, dtype=torch.bool, device=dev)
    head[1:] = tgt_s[1:] != tgt_s[:-1]
    heads = torch.nonzero(head & (tgt_s < N)).squeeze(1)
    if heads.numel() == 0:
        return neighbors_l
    A = min(deg, 16)
    add_pos = heads[:, None] + torch.arange(A, device=dev)
    safe_pos = add_pos.clamp(max=R - 1)
    t = tgt_s[heads]
    in_run = (add_pos < R) & (tgt_s[safe_pos] == t[:, None])
    add_ids = torch.where(in_run, src_s[safe_pos], -1)
    cand = torch.cat([neighbors_l[t].long(), add_ids], 1)     # (T, deg + A)
    cvalid = cand >= 0
    cvecs = vectors[torch.where(cvalid, cand, 0)]
    dis = torch.where(cvalid, batch_dists(vectors[t], cvecs, metric),
                      float("inf"))
    # an addition may already be a neighbour: later duplicates masked
    dup = cvalid & ~dedupe_first(cand, cvalid)
    dis = torch.where(dup, float("inf"), dis)
    cand = torch.where(torch.isfinite(dis), cand, -1)
    neighbors_l[t] = select_neighbors_heuristic(cand, dis, vectors, deg,
                                                metric)[0]
    return neighbors_l


def insert_wave_level(vectors: torch.Tensor, neighbors_l: torch.Tensor,
                      xq_wave: torch.Tensor, wave_ids: torch.Tensor,
                      entry_ids: torch.Tensor, *, m_fwd: int,
                      ef_construction: int, metric: int = D.METRIC_L2):
    """Insert one wave at one level (reference :487): beam-search the
    pre-wave graph from ``entry_ids`` (W, E) for ef_construction
    candidates, keep m_fwd forward links by the heuristic, write them and
    the reverse links. ``vectors`` / ``neighbors_l`` / the ids may be a
    compacted row space (the upper levels). Updates ``neighbors_l`` in
    place; returns it and each point's 8 nearest (W, 8), -1 padded, the
    seeds of the next level down."""
    cd, ci, _ = beam_search_level0(vectors, neighbors_l, xq_wave, entry_ids,
                                   ef=ef_construction, k=ef_construction,
                                   expand=2, metric=metric, raw=True)
    # never link a point to itself
    self_hit = ci.long() == wave_ids.long()[:, None]
    cd = torch.where(self_hit, float("inf"), cd)
    ci = torch.where(self_hit, -1, ci)
    fwd = select_neighbors_heuristic(ci, cd, vectors, m_fwd, metric)[0]
    neighbors_l[wave_ids.long()] = fwd
    neighbors_l = apply_reverse_links(vectors, neighbors_l, fwd, wave_ids,
                                      metric)
    seeds = torch.where(torch.isfinite(cd[:, :8]), ci[:, :8], -1)
    return neighbors_l, seeds


def _upper_tables(levels: np.ndarray):
    """(upper_ids (U,) int32 sorted, Lmax) of a level draw; one pad row
    when no node is above level 0 (reference :552-557)."""
    upper_ids = np.nonzero(levels >= 1)[0].astype(np.int32)
    if len(upper_ids) == 0:
        return np.array([0], np.int32), 1
    return upper_ids, max(int(levels.max()), 1)


def build_graph(vectors, m: int, ef_construction: int, *,
                levels: Optional[np.ndarray] = None, seed: int = 1234,
                wave_size: int = 1024, metric: int = D.METRIC_L2,
                verbose: bool = False, device=None) -> HNSWGraph:
    """The multilevel graph by level-bucketed wave insertion (reference
    :526, `hnsw_add_vertices`): the entry point is the first node of the
    highest level; the other nodes go high level to low, each bucket in
    waves of 64, 128, ... up to ``wave_size`` points. A wave descends
    greedily from the entry through the levels above its own, inserts
    itself at each of its levels (upper levels in their compacted row
    space, seeded by the level above's 8 nearest), then at level 0.
    ``vectors``: (n, d) numpy array or tensor, on ``device`` (default: the
    tensor's, else "cuda"). `InterruptCallback.check()` runs before every
    wave."""
    # imported here: utils/__init__ imports the models, which import this
    from ..utils.interrupt import InterruptCallback

    if device is None:
        device = vectors.device if isinstance(vectors, torch.Tensor) \
            else "cuda"
    x_dev = torch.as_tensor(vectors).to(device=device,
                                        dtype=torch.float32).contiguous()
    n = x_dev.shape[0]
    m0 = 2 * m
    if levels is None:
        levels = random_levels(n, m, seed)
    levels = np.asarray(levels, np.int32)
    max_level = int(levels.max(initial=0))
    upper_np, lmax_tab = _upper_tables(levels)
    u = len(upper_np)
    i32 = torch.int32
    upper_ids = torch.from_numpy(upper_np).to(device)
    upper_lv = torch.from_numpy(levels[upper_np]).to(device)
    levels_dev = torch.from_numpy(levels).to(device)
    neighbors0 = torch.full((n, m0), -1, dtype=i32, device=device)
    upper_nb = torch.full((u, lmax_tab, m), -1, dtype=i32, device=device)
    vectors_u = x_dev[upper_ids.long()]
    order = np.argsort(-levels, kind="stable")
    entry = int(order[0])
    graph = HNSWGraph(neighbors0=neighbors0, upper_ids=upper_ids,
                      upper_neighbors=upper_nb, levels=levels_dev,
                      entry=entry, max_level=max_level)
    done = 1
    for pt_level in range(max_level, -1, -1):
        bucket = order[levels[order] == pt_level]
        bucket = bucket[bucket != entry]
        i0, w = 0, 32
        while i0 < len(bucket):
            InterruptCallback.check()
            w = min(w * 2, wave_size)
            wave = torch.from_numpy(bucket[i0:i0 + w]).to(device)
            i0 += len(wave)
            xw = x_dev[wave]
            cur = torch.full((len(wave),), entry, dtype=i32, device=device)
            cur_d = batch_dists(xw, x_dev[cur.long()][:, None], metric)[:, 0]
            for lev in range(max_level, pt_level, -1):
                cur, cur_d = greedy_level(x_dev, graph, xw, lev, cur, cur_d,
                                          metric=metric)
            seeds = cur[:, None]
            wave_rows = torch.searchsorted(upper_ids, wave.to(i32))
            for lev in range(min(pt_level, max_level), 0, -1):
                adj = upper_nb[:, lev - 1]
                adj_rows = torch.where(
                    adj >= 0,
                    torch.searchsorted(upper_ids, adj.contiguous()).to(i32),
                    -1)
                # a seed must be an upper node of level >= lev
                ok = seeds >= 0
                rclip = torch.searchsorted(
                    upper_ids, torch.where(ok, seeds, 0).to(i32)
                ).clamp(0, u - 1)
                good = ok & (upper_ids[rclip] == seeds) & \
                    (upper_lv[rclip] >= lev)
                adj_rows, seed_out = insert_wave_level(
                    vectors_u, adj_rows, xw, wave_rows,
                    torch.where(good, rclip, -1).to(i32), m_fwd=m,
                    ef_construction=ef_construction, metric=metric)
                upper_nb[:, lev - 1] = torch.where(
                    adj_rows >= 0, upper_ids[adj_rows.long().clamp(0, u - 1)],
                    -1)
                seeds = torch.where(
                    seed_out >= 0,
                    upper_ids[seed_out.long().clamp(0, u - 1)], -1)
            insert_wave_level(x_dev, neighbors0, xw, wave, seeds, m_fwd=m0,
                              ef_construction=ef_construction, metric=metric)
            done += len(wave)
            if verbose:
                print(f"hnsw build: level {pt_level}, {done}/{n}")
    return graph


def extend_graph(vectors, graph: HNSWGraph, n_old: int, *, m: int,
                 ef_construction: int,
                 levels_new: Optional[np.ndarray] = None, seed: int = 1234,
                 wave_size: int = 1024, metric: int = D.METRIC_L2,
                 verbose: bool = False, device=None) -> HNSWGraph:
    """Insert rows n_old..n-1 of ``vectors`` into ``graph`` (reference
    :1112, `hnsw_add_vertices` on a non-empty index): waves of
    ``wave_size`` new rows descend the OLD upper levels from the old entry
    and wave-insert into level 0 (later waves see the earlier ones); the
    upper levels are then relinked over the merged subsets by
    `link_upper_levels`. New levels are drawn with the offset seed
    (seed + n_old), so repeated adds stay deterministic.
    `InterruptCallback.check()` runs before every wave, as the
    reference's."""
    from ..utils.interrupt import InterruptCallback

    if device is None:
        device = graph.neighbors0.device
    x_dev = torch.as_tensor(vectors).to(device=device,
                                        dtype=torch.float32).contiguous()
    n = x_dev.shape[0]
    n_new = n - n_old
    if n_new <= 0:
        return graph
    m0 = graph.m0
    if levels_new is None:
        levels_new = random_levels(n_new, m, seed, offset=n_old)
    levels = np.concatenate([graph.levels.cpu().numpy().astype(np.int32),
                             np.asarray(levels_new, np.int32)])
    i32 = torch.int32
    neighbors0 = torch.cat([graph.neighbors0, torch.full(
        (n_new, m0), -1, dtype=i32, device=device)])
    for i0 in range(0, n_new, wave_size):
        InterruptCallback.check()
        wave = torch.arange(n_old + i0, min(n_old + i0 + wave_size, n),
                            device=device)
        xw = x_dev[wave]
        cur = torch.full((len(wave),), int(graph.entry), dtype=i32,
                         device=device)
        cur_d = batch_dists(xw, x_dev[cur.long()][:, None], metric)[:, 0]
        for lev in range(graph.max_level, 0, -1):
            cur, cur_d = greedy_level(x_dev, graph, xw, lev, cur, cur_d,
                                      metric=metric)
        insert_wave_level(x_dev, neighbors0, xw, wave, cur[:, None],
                          m_fwd=m0, ef_construction=ef_construction,
                          metric=metric)
        if verbose:
            print(f"hnsw extend: {min(i0 + wave_size, n_new)}/{n_new}")
    upper_ids, upper_neighbors = link_upper_levels(x_dev, levels, m, metric)
    return HNSWGraph(
        neighbors0=neighbors0,
        upper_ids=torch.from_numpy(upper_ids).to(device),
        upper_neighbors=torch.from_numpy(upper_neighbors).to(device),
        levels=torch.from_numpy(levels).to(device),
        entry=int(np.argmax(levels)), max_level=int(levels.max(initial=0)))


# ---------------------------------------------------------------------------
# the batch kNN-graph build (reference :703-1110)
# ---------------------------------------------------------------------------

def knn_candidates(x_dev: torch.Tensor, C: int, metric: int, seed: int,
                   verbose: bool = False):
    """kNN table of every row used as link candidates (reference :704):
    the exact blocked product (bf16 pass, f32 re-rank of 2C) for n <= 32768,
    else k-means (6 Lloyd iterations on 96 points a centroid), 6 probes a
    row and the query-major scan of the lists. Returns (dis (n, C + 1)
    user-facing, ids (n, C + 1) int32, assign (n,) int64 numpy or None)."""
    n = x_dev.shape[0]
    C = min(C, n - 1)
    if n <= 32768:
        dis, ids = D.knn(x_dev, x_dev, min(C + 1, n), metric,
                         compute_dtype="bfloat16", approx=n > 8192,
                         refine_factor=2)
        return dis, ids.to(torch.int32), None
    nlist = int(min(16384, max(256, n // 256)))
    cp = ClusteringParameters(niter=6, seed=seed, verbose=verbose,
                              max_points_per_centroid=96,
                              early_stop_tol=5e-3)
    centroids, _ = kmeans(x_dev.cpu().numpy(), nlist, cp, metric,
                          device=x_dev.device)
    _, probes = D.knn(x_dev, torch.from_numpy(centroids).to(x_dev.device), 6,
                      metric, compute_dtype="bfloat16", approx=True)
    assign = probes[:, 0].cpu().numpy().astype(np.int64)
    pil = IV.pack_invlists_device(x_dev, np.arange(n, dtype=np.int64),
                                  assign, nlist)
    mnb = pil.max_nblocks_per_list
    pend = []
    for i0 in range(0, n, 65536):
        dc, ic, _ = IV.scan_invlists(x_dev[i0:i0 + 65536],
                                     probes[i0:i0 + 65536], pil, C + 1,
                                     metric, max_nblocks=mnb)
        pend.append((dc, ic))
        if verbose:
            print(f"hnsw knn-candidates: {min(i0 + 65536, n)}/{n}")
    return (torch.cat([p[0] for p in pend]), torch.cat([p[1] for p in pend]),
            assign)


def drop_self(dis: torch.Tensor, ids: torch.Tensor, C: int,
              row_ids: Optional[torch.Tensor] = None):
    """Remove each row's own id (and -1s) from its canonical candidate
    list and keep the C best (reference :765-791)."""
    own = torch.arange(ids.shape[0], device=ids.device) if row_ids is None \
        else row_ids
    bad = (ids < 0) | (ids == own[:, None].to(ids.dtype))
    dis = torch.where(bad, float("inf"), dis)
    ids = torch.where(bad, -1, ids)
    dis, order = torch.sort(dis, dim=1, stable=True)
    return dis[:, :C], _take(ids, order[:, :C])


def reverse_candidates(fwd: torch.Tensor, fwd_dis: torch.Tensor, cap: int):
    """For each node v, up to ``cap`` nodes u with v in fwd[u], in
    increasing u (and link) order, with the edge distances (reference
    :824-924; its host and device routes give this same table). A stable
    sort of the edges by destination and one scatter."""
    n, m = fwd.shape
    dev = fwd.device
    dst = fwd.reshape(-1).long()
    src = torch.arange(n * m, device=dev) // m
    sk, order = torch.sort(torch.where(dst >= 0, dst, n), stable=True)
    ss, sd = src[order], fwd_dis.reshape(-1)[order]
    idx = torch.arange(n * m, device=dev)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sk[1:] != sk[:-1]])
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    pos = idx - start
    keep = (sk < n) & (pos < cap)
    rev_ids = torch.full((n, cap), -1, dtype=torch.int32, device=dev)
    rev_dis = torch.full((n, cap), float("inf"), device=dev)
    rev_ids[sk[keep], pos[keep]] = ss[keep].to(torch.int32)
    rev_dis[sk[keep], pos[keep]] = sd[keep].float()
    return rev_ids, rev_dis


def merge_prune(vectors, fwd, fwd_dis, rev_ids, rev_dis, m: int,
                metric: int) -> torch.Tensor:
    """Each node's final list: the diversity prune of its forward and
    reverse candidates, duplicates masked (reference :925)."""
    cand = torch.cat([fwd.to(torch.int32), rev_ids], 1)
    cdis = torch.cat([fwd_dis.float(), rev_dis], 1)
    dup = ~dedupe_first(cand, torch.ones_like(cand, dtype=torch.bool))
    cdis = torch.where(dup | (cand < 0), float("inf"), cdis)
    cand = torch.where(dup, -1, cand)
    return prune_all(vectors, cand, cdis, m, metric)[0]


def build_graph_knn(vectors, m: int, ef_construction: int, *,
                    levels: Optional[np.ndarray] = None, seed: int = 1234,
                    metric: int = D.METRIC_L2, verbose: bool = False,
                    prune_mode: str = "single", device=None):
    """HNSW-compatible graph from a batch kNN table (reference :947).
    ``vectors``: (n, d) numpy array or tensor; the graph is built on
    ``device`` (default: the tensor's, else "cuda"). ef_construction sizes
    the candidate pool; prune_mode "single" rank-truncates the forward
    links and prunes once at the merge, "double" prunes the forward links
    too. Each node takes at most m reverse candidates (the reference's
    default cap). Returns (graph, coarse assignment (n,) int64 numpy or
    None)."""
    if device is None:
        device = vectors.device if isinstance(vectors, torch.Tensor) \
            else "cuda"
    x_dev = torch.as_tensor(vectors).to(device=device,
                                        dtype=torch.float32).contiguous()
    n = x_dev.shape[0]
    m0 = 2 * m
    similarity = D.is_similarity_metric(metric)
    if levels is None:
        levels = random_levels(n, m, seed)
    levels = np.asarray(levels, np.int32)
    max_level = int(levels.max(initial=0))

    C = int(min(max(m0 + 16, ef_construction), max(n - 1, 1)))
    dis, ids, assign = knn_candidates(x_dev, C, metric, seed, verbose)
    if similarity:
        dis = -dis                       # canonical ascending-best
    dis, ids = drop_self(dis, ids, C)
    vec_bf16 = x_dev.to(torch.bfloat16)
    if prune_mode == "single":
        fwd, fwd_dis = ids[:, :m0], dis[:, :m0]
    else:
        fwd, fwd_dis = prune_all(vec_bf16, ids, dis, m0, metric)
    rev_ids, rev_dis = reverse_candidates(fwd, fwd_dis, m)
    neighbors0 = merge_prune(vec_bf16, fwd, fwd_dis, rev_ids, rev_dis, m0,
                             metric)
    del vec_bf16, rev_ids, rev_dis, fwd, fwd_dis, dis, ids
    upper_ids, upper_neighbors = link_upper_levels(x_dev, levels, m, metric)
    graph = HNSWGraph(
        neighbors0=neighbors0,
        upper_ids=torch.from_numpy(upper_ids).to(device),
        upper_neighbors=torch.from_numpy(upper_neighbors).to(device),
        levels=torch.from_numpy(levels).to(device),
        entry=int(np.argmax(levels)), max_level=max_level)
    return graph, assign


def link_upper_levels(x_dev: torch.Tensor, levels: np.ndarray, m: int,
                      metric: int):
    """Link every upper level by exact kNN (bf16 pass, f32 re-rank) and the
    diversity prune within the level's node subset, padded to the
    reference's power-of-two sizes (reference :1037). Returns (upper_ids
    (U,) int32, upper_neighbors (U, Lmax, m) int32 global ids), numpy."""
    similarity = D.is_similarity_metric(metric)
    max_level = int(levels.max(initial=0))
    upper_ids = np.nonzero(levels >= 1)[0].astype(np.int32)
    if len(upper_ids) == 0:
        upper_ids = np.array([0], np.int32)
        lmax_tab = 1
    else:
        lmax_tab = max(max_level, 1)
    u = len(upper_ids)
    d = x_dev.shape[1]
    upper_neighbors = np.full((u, lmax_tab, m), -1, np.int32)
    n1 = int((levels >= 1).sum())
    if n1 <= 1 or max_level < 1:
        return upper_ids, upper_neighbors
    for lev in range(1, max_level + 1):
        sub = np.nonzero(levels >= lev)[0].astype(np.int32)
        ns = len(sub)
        if ns <= 1:
            continue
        floor = 12 if n1 > 8192 else 7
        P = 1 << max(int(np.ceil(np.log2(max(ns, 2)))), floor)
        cu = int(min(max(m + 8, 32), P - 1))
        xp = torch.zeros((P, d), dtype=torch.float32, device=x_dev.device)
        xp[:ns] = x_dev[torch.from_numpy(sub).to(x_dev.device).long()]
        sd, si = D.knn(xp, xp, min(cu + 1, P), metric, valid_n=ns,
                       compute_dtype="bfloat16", approx=P > 8192,
                       refine_factor=2)
        if similarity:
            sd = -sd
        sd, si = drop_self(sd, si.to(torch.int32), cu)
        # pad rows would leak reverse edges; non-finite candidates are
        # masked database rows
        si = torch.where(torch.isfinite(sd), si, -1)
        sfwd, sdis = prune_all(xp, si, sd, m, metric)
        sfwd[ns:] = -1
        sdis[ns:] = float("inf")
        srev, srd = reverse_candidates(sfwd, sdis, m)
        slinks = merge_prune(xp, sfwd, sdis, srev, srd, m,
                             metric)[:ns].cpu().numpy()
        glob = np.where(slinks >= 0, sub[np.clip(slinks, 0, ns - 1)], -1)
        upper_neighbors[np.searchsorted(upper_ids, sub), lev - 1] = glob
    return upper_ids, upper_neighbors
