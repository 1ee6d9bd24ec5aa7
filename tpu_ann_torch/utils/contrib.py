"""Contrib tooling — PyTorch counterpart of `tpu_ann/utils/contrib.py`
(faiss `contrib/exhaustive_search.py`, `contrib/big_batch_search.py`,
`contrib/ivf_tools.py`, `contrib/inspect_tools.py`,
`contrib/clustering.py`, `python/extra_wrappers.py` and
`faiss/MatrixStats`).

- `knn_ground_truth` / `range_ground_truth`: exact f32 ground truth over
  an iterator of database chunks, on ``device``; the merge across chunks
  is a stable sort, so a tie goes to the earlier chunk.
- `big_batch_search`: batches of queries through the index's
  `search_device`, up to ``pipeline_depth`` in flight, with a pickle
  checkpoint that either package resumes from.
- `add_preassigned`, `merge_indexes`, `range_search_preassigned`,
  `permute_invlists`, `sort_invlists_by_size`: IVF surgery.
- The inspect tools, `MatrixStats`, `kmin` / `kmax` / `bucket_sort` /
  `rand_smooth_vectors`, two-level clustering and the `DatasetAssign`
  k-means loop.

Functions that do device work take ``device=`` ("cuda" by default) and
fail without a GPU, as the indexes do; those that work on an index use its
device.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from collections import deque
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..ops import distances as D
from ..ops import topk as TK


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(
        x.cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _to(x, device) -> torch.Tensor:
    return torch.from_numpy(_f32(x)).to(device)


def knn_ground_truth(xq: np.ndarray, db_iterator: Iterable[np.ndarray],
                     k: int, metric: int = D.METRIC_L2, *,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN over a streamed database (exhaustive_search.py:24; the
    ground truth of recall tests): the exact f32 `knn` of each chunk (TF32
    off), merged into the running (nq, k) by a stable sort, so on equal
    distances the rows of an earlier chunk win (the reference's merge is
    an unstable argsort)."""
    xq_dev = _to(xq, device)
    nq = len(xq_dev)
    similarity = D.is_similarity_metric(metric)
    bd = torch.full((nq, k), D.worst_value(metric), device=xq_dev.device)
    bi = torch.full((nq, k), -1, dtype=torch.int64, device=xq_dev.device)
    base = 0
    for chunk in db_iterator:
        xb = _to(chunk, device)
        Dv, Iv = D.knn(xq_dev, xb, k, metric)
        Iv = torch.where(Iv >= 0, Iv + base, -1)
        bd, bi = TK.merge_topk(bd, bi, Dv, Iv, k, similarity=similarity)
        base += len(xb)
    return bd.cpu().numpy(), bi.cpu().numpy()


def big_batch_search(
    index,
    xq: np.ndarray,
    k: int,
    *,
    batch_size: int = 8192,
    pipeline_depth: int = 3,
    checkpoint_path: Optional[str] = None,
    checkpoint_freq: int = 8,
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Search a huge query set in batches, with an optional checkpoint
    (contrib/big_batch_search.py semantics: on a restart the batches that
    are done are skipped).

    `InterruptCallback.check()` runs before each batch. With an index that
    has `search_device`, a batch is queued on the device and up to
    ``pipeline_depth`` batches stay in flight: each is finalized (copied
    back, ids mapped, checkpointed) after the next one is queued, so the
    host work overlaps the device's. The last batch keeps its own size.
    The checkpoint is the reference's pickle, {"done", "D", "I"}, written
    through ``checkpoint_path + ".tmp"``."""
    from .interrupt import InterruptCallback

    nq = len(xq)
    nbatch = -(-nq // batch_size)
    done = np.zeros(nbatch, bool)
    Dout = np.zeros((nq, k), np.float32)
    Iout = np.full((nq, k), -1, np.int64)
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path, "rb") as f:
            st = pickle.load(f)
        done, Dout, Iout = st["done"], st["D"], st["I"]
        if verbose:
            print(f"big_batch_search: resuming, {done.sum()}/{nbatch} done")

    search_device = getattr(index, "search_device", None)
    map_ids = getattr(index, "_map_ids", None)

    def host(a) -> np.ndarray:
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    def finalize(entry) -> None:
        b, Dv, Iv = entry
        i0, i1 = b * batch_size, min((b + 1) * batch_size, nq)
        Dout[i0:i1] = host(Dv)
        Ih = host(Iv)
        Iout[i0:i1] = map_ids(Ih) if map_ids is not None else Ih
        done[b] = True
        if checkpoint_path and (b % checkpoint_freq == 0 or b == nbatch - 1):
            tmp = checkpoint_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump({"done": done, "D": Dout, "I": Iout}, f)
            os.replace(tmp, checkpoint_path)
        if verbose:
            print(f"big_batch_search: batch {b + 1}/{nbatch}")

    inflight: deque = deque()
    depth = max(1, int(pipeline_depth))
    for b in range(nbatch):
        InterruptCallback.check()
        if done[b]:
            continue
        i0, i1 = b * batch_size, min((b + 1) * batch_size, nq)
        if search_device is not None:
            xh = (index._check_input(xq[i0:i1])
                  if hasattr(index, "_check_input") else _f32(xq[i0:i1]))
            xq_dev = index._to_device(xh) if hasattr(index, "_to_device") \
                else torch.from_numpy(xh).to(index.device)
            inflight.append((b, *search_device(xq_dev, k)))
            if len(inflight) > depth:
                finalize(inflight.popleft())
        else:
            Dv, Iv = index.search(xq[i0:i1], k)
            finalize((b, Dv, Iv))
    while inflight:
        finalize(inflight.popleft())
    return Dout, Iout


def merge_indexes(dst, srcs) -> None:
    """Merge IVF shards into ``dst`` (IndexIVF::merge_from /
    contrib.ondisk.merge_ondisk; reference :172-184). All must share the
    trained quantizer, so each shard's host chunks move over with their
    cached coarse assignments, and ``dst`` repacks once."""
    for src in srcs:
        if src.nlist != dst.nlist or src.d != dst.d:
            raise ValueError("incompatible shard")
        if src._pending_removals():
            # compact first: the reference merges the removed rows of its
            # host store back in
            src._repack()
        else:
            src._maybe_repack()
        for xs, ids, a in zip(src._xb_host, src._ids_host,
                              src._assign_host):
            dst._append_chunk(xs, ids, a)
    dst._repack()


def add_preassigned(index_ivf, x: np.ndarray, a: np.ndarray,
                    ids: Optional[np.ndarray] = None) -> None:
    """Add rows with their coarse assignment given (contrib/ivf_tools.py
    add_preassigned; reference :157-169): the chunk keeps ``a`` as its
    cached assignment, so the repack assigns nothing."""
    x = np.ascontiguousarray(x, np.float32)
    if ids is None:
        ids = np.arange(index_ivf.ntotal, index_ivf.ntotal + len(x),
                        dtype=np.int64)
    index_ivf._append_chunk(x.copy(), np.asarray(ids, np.int64).copy(),
                            np.asarray(a, np.int64))
    index_ivf._repack()


@dataclasses.dataclass
class MatrixStats:
    """Training-set diagnostics (faiss/MatrixStats.{h,cpp}); numpy, as in
    the reference."""

    n: int
    d: int
    n_nan: int
    n_inf: int
    n_zero_rows: int
    n_dup_rows: int
    n_constant_dims: int
    min_norm2: float
    max_norm2: float
    comments: str

    @classmethod
    def compute(cls, x: np.ndarray) -> "MatrixStats":
        x = np.asarray(x, np.float32)
        n, d = x.shape
        n_nan = int(np.isnan(x).sum())
        n_inf = int(np.isinf(x).sum())
        norms = np.where(np.isfinite(x), x, 0).astype(np.float64)
        norms = (norms ** 2).sum(1)
        n_zero = int((norms == 0).sum())
        const_dims = int((x.max(0) == x.min(0)).sum()) if n else 0
        # duplicate rows by their bytes (MatrixStats.cpp's occurrence-count
        # hashtable)
        if n:
            _, cnt = np.unique(x.view(np.uint8).reshape(n, -1), axis=0,
                               return_counts=True)
            n_dup = int((cnt - 1).sum())
        else:
            n_dup = 0
        comments = []
        if n_nan:
            comments.append(f"{n_nan} NaN values")
        if n_inf:
            comments.append(f"{n_inf} non-finite values")
        if n_zero:
            comments.append(f"{n_zero} zero rows")
        if n_dup:
            comments.append(f"{n_dup} duplicate rows")
        if const_dims:
            comments.append(f"{const_dims} constant dimensions")
        if not comments:
            comments.append("no obvious problems")
        return cls(n=n, d=d, n_nan=n_nan, n_inf=n_inf,
                   n_zero_rows=n_zero, n_dup_rows=n_dup,
                   n_constant_dims=const_dims,
                   min_norm2=float(norms.min(initial=0)),
                   max_norm2=float(norms.max(initial=0)),
                   comments="; ".join(comments))


# ---------------------------------------------------------------------------
# inspect tools (contrib/inspect_tools.py; reference :246-283, 578-627)
# ---------------------------------------------------------------------------

def get_invlist(index_ivf, l: int) -> Tuple[np.ndarray, np.ndarray]:
    """(user ids, stored rows or codes) of inverted list ``l``, as numpy:
    the raw f32 rows of a Flat IVF, the codes of a coded one."""
    index_ivf._maybe_repack()
    il = index_ivf.invlists
    payload = il.data if hasattr(il, "data") else il.codes
    width = payload.shape[2]
    b0, nb = int(il.list_block_start[l]), int(il.list_nblocks[l])
    if nb == 0:
        return np.zeros(0, np.int64), payload[:0, 0].cpu().numpy()
    ids = il.ids[b0:b0 + nb].reshape(-1).cpu().numpy()
    rows = payload[b0:b0 + nb].reshape(-1, width).cpu().numpy()
    keep = ids >= 0
    return index_ivf._map_ids(ids[keep]), rows[keep]


def get_invlist_sizes(index_ivf) -> np.ndarray:
    return index_ivf.list_sizes


def get_pq_centroids(index) -> np.ndarray:
    """(M, ksub, dsub) PQ codebook of a PQ-bearing index
    (inspect_tools.get_pq_centroids)."""
    pq = getattr(index, "pq", None)
    if pq is None:
        raise ValueError(f"{type(index).__name__} has no PQ codec")
    return np.asarray(pq.centroids, np.float32)


def get_linear_transform(vt) -> Tuple[np.ndarray, np.ndarray]:
    """(A, b) of a LinearTransform, y = x @ A.T + b
    (inspect_tools.get_LinearTransform_matrix)."""
    A = np.asarray(vt.A, np.float32)
    b = getattr(vt, "b", None)
    b = (np.zeros(A.shape[0], np.float32) if b is None
         else np.asarray(b, np.float32))
    return A, b


def make_LinearTransform_matrix(A: np.ndarray,
                                b: Optional[np.ndarray] = None, *,
                                device="cuda"):
    """A LinearTransform from an explicit (d_out, d_in) matrix and an
    optional bias (inspect_tools.py:71)."""
    from ..models.transforms import LinearTransform

    A = np.ascontiguousarray(A, np.float32)
    d_out, d_in = A.shape
    vt = LinearTransform(d_in, d_out, device=device)
    vt.A = A
    vt.b = (np.zeros(d_out, np.float32) if b is None
            else np.ascontiguousarray(b, np.float32))
    vt.is_trained = True
    return vt


def get_flat_data(index_flat) -> np.ndarray:
    """(ntotal, d) float32 stored vectors (inspect_tools.py:95)."""
    return index_flat.vectors[:index_flat.ntotal].float().cpu().numpy()


def get_flat_codes(index_flat_codes) -> np.ndarray:
    """(ntotal, code_size) raw codes of a flat-codec index
    (inspect_tools.py:101)."""
    codes = index_flat_codes._codes
    if codes is None:
        return np.zeros((0, index_flat_codes.sa_code_size()), np.uint8)
    return codes[:index_flat_codes.ntotal].cpu().numpy()


def get_additive_quantizer_codebooks(index_aq) -> np.ndarray:
    """(M, ksub, d) codebooks of an RQ / LSQ index (inspect_tools.py:85)."""
    codec = getattr(index_aq, "codec", None) or getattr(index_aq, "rq", None)
    if codec is None:
        raise ValueError(f"{type(index_aq).__name__} has no trained "
                         f"additive codec")
    return np.asarray(codec.codebooks, np.float32)


def get_NSG_neighbors(index_nsg) -> np.ndarray:
    """(ntotal, R) neighbour table, -1 padded (inspect_tools.py:107)."""
    if index_nsg.graph is None:
        raise ValueError("the NSG index has no graph yet")
    return index_nsg.graph.cpu().numpy().astype(np.int64)


def print_object_fields(obj) -> None:
    """Print the public scalar fields of an index or quantizer
    (inspect_tools.py:49)."""
    for name in sorted(vars(obj)):
        if name.startswith("_"):
            continue
        v = getattr(obj, name)
        if isinstance(v, (int, float, bool, str, type(None))):
            print(f"{name} = {v!r}")
        else:
            print(f"{name} = <{type(v).__name__}>")


# ---------------------------------------------------------------------------
# range tools (contrib/exhaustive_search.py)
# ---------------------------------------------------------------------------

def range_search_max_results(index, xq: np.ndarray, radius: float, *,
                             max_results: int,
                             min_results: Optional[int] = None,
                             batch_size: int = 4096):
    """Range search whose radius tightens so the result table stays under
    ``max_results`` (exhaustive_search.py range_search_max_results): the
    queries go in batches; when the results collected so far pass
    ``max_results``, the radius shrinks to the distance of the
    ``min_results``-th closest of them and the earlier batches are
    filtered again. Returns (radius, lims, D, I)."""
    if min_results is None:
        min_results = int(0.8 * max_results)
    # similarity metrics keep D >= radius, distances D <= radius: one sign
    sgn = -1.0 if bool(getattr(index, "is_similarity", False)) else 1.0
    chunks = []   # [lims, D, I] a batch, after filtering
    total = 0
    cur_radius = float(radius)
    nq = len(xq)
    for i0 in range(0, nq, batch_size):
        lims, Dv, Iv = index.range_search(xq[i0:i0 + batch_size],
                                          cur_radius)
        chunks.append([np.asarray(lims), np.asarray(Dv), np.asarray(Iv)])
        total += len(Dv)
        if total > max_results:
            alld = np.concatenate([c[1] * sgn for c in chunks])
            kth = min(min_results, len(alld) - 1)
            new_r = np.partition(alld, kth)[kth]
            cur_radius = float(new_r * sgn)
            total = 0
            for c in chunks:
                lims_c, Dc, Ic = c
                nb_q = len(lims_c) - 1
                qid = np.repeat(np.arange(nb_q), np.diff(lims_c))
                keep = Dc * sgn <= new_r
                l2 = np.zeros(nb_q + 1, np.int64)
                l2[1:] = np.cumsum(np.bincount(qid[keep], minlength=nb_q))
                c[0], c[1], c[2] = l2, Dc[keep], Ic[keep]
                total += len(c[1])
    lims = np.zeros(nq + 1, np.int64)
    pos = 0
    Dout, Iout = [], []
    for bi, (lc, Dv, Iv) in enumerate(chunks):
        i0 = bi * batch_size
        nb_q = len(lc) - 1
        lims[i0 + 1:i0 + nb_q + 1] = pos + lc[1:]
        Dout.append(Dv)
        Iout.append(Iv)
        pos += len(Dv)
    return (cur_radius, lims,
            np.concatenate(Dout) if Dout else np.zeros(0, np.float32),
            np.concatenate(Iout) if Iout else np.zeros(0, np.int64))


def range_ground_truth(xq, db_iterator, threshold: float,
                       metric_type: int = D.METRIC_L2, *, device="cuda"):
    """Exact range-search ground truth over a database iterator
    (exhaustive_search.py:152): each block through the exact
    `range_search_blocked` on ``device``, and `csr_from_hits` over the
    blocks' hits with global ids, so each query's hits come in block
    order. Returns (lims, D, I)."""
    from ..ops.range_search import csr_from_hits, range_search_blocked

    xq = _f32(xq)
    nq = len(xq)
    hits = ([], [], [])
    base = 0
    for block in db_iterator:
        xb = _to(block, device)
        res = range_search_blocked(xq, xb, threshold, metric_type,
                                   valid_n=len(xb))
        hits[0].append(torch.from_numpy(
            np.repeat(np.arange(nq), np.diff(res.lims))))
        hits[1].append(torch.from_numpy(res.distances))
        hits[2].append(torch.from_numpy(res.labels + base))
        base += len(xb)
    res = csr_from_hits(nq, *hits)
    return res.lims, res.distances, res.labels


def exponential_query_iterator(xq, start_bs: int = 32, max_bs: int = 20000):
    """Query batches of exponentially growing size
    (exhaustive_search.py:355): small batches first so early results come
    back fast, then large ones for throughput."""
    i0, bs = 0, start_bs
    while i0 < len(xq):
        yield xq[i0:i0 + bs]
        i0 += bs
        bs = min(bs * 2, max_bs)


# ---------------------------------------------------------------------------
# small array utilities (python/extra_wrappers.py)
# ---------------------------------------------------------------------------

def kmin(Dm: np.ndarray, k: int, *, device="cuda"):
    """Per-row k smallest values and their indices, ascending
    (extra_wrappers.py ``kmin``): a stable sort on ``device``, so a tie
    keeps the lower index, as ``lax.top_k`` does."""
    v, i = TK.topk(_to(Dm, device), k)
    return v.cpu().numpy(), i.cpu().numpy()


def kmax(Dm: np.ndarray, k: int, *, device="cuda"):
    """Per-row k largest values and their indices, descending
    (extra_wrappers.py ``kmax``); ties keep the lower index."""
    v, i = TK.topk(_to(Dm, device), k, similarity=True)
    return v.cpu().numpy(), i.cpu().numpy()


def bucket_sort(tab: np.ndarray, nbucket: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Counting sort (extra_wrappers.py ``bucket_sort``): (lims (nbucket +
    1,), perm) with perm[lims[i]:lims[i + 1]] the positions j where tab[j]
    == i, in increasing j."""
    tab = np.asarray(tab).ravel()
    if nbucket is None:
        nbucket = int(tab.max(initial=-1)) + 1
    if len(tab) and (tab.min() < 0 or tab.max() >= nbucket):
        raise ValueError(
            f"bucket_sort: values must be in [0, {nbucket}); got "
            f"[{tab.min()}, {tab.max()}]")
    counts = np.bincount(tab, minlength=nbucket)
    lims = np.zeros(nbucket + 1, np.int64)
    np.cumsum(counts[:nbucket], out=lims[1:])
    perm = np.argsort(tab, kind="stable").astype(np.int64)
    return lims, perm


def rand_smooth_vectors(n: int, d: int, seed: int = 1234) -> np.ndarray:
    """Random vectors with smooth (low-frequency) structure along the
    dimension axis, L2-normalized (extra_wrappers.py
    ``rand_smooth_vectors`` role)."""
    rs = np.random.RandomState(seed)
    x = np.cumsum(rs.randn(n, d).astype(np.float32), axis=1)
    x -= x.mean(axis=1, keepdims=True)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return x


# ---------------------------------------------------------------------------
# two-level clustering (contrib/clustering.py:24-127): sqrt(nlist)
# first-level clusters, each split by its own k-means
# ---------------------------------------------------------------------------

def two_level_clustering(xt: np.ndarray, nc1: int, nc2: int, *,
                         rebalance: bool = True, clustering_niter: int = 25,
                         cp=None, verbose: bool = False,
                         batched: bool = False,
                         device="cuda") -> np.ndarray:
    """(nc2, d) float32 centroids. ``rebalance`` sizes each cell's
    sub-cluster budget by its first-level population (the reference's
    cumulative-share split); otherwise budgets are equal.

    ``batched=True`` (equal budgets: rebalance=False and nc1 | nc2) runs
    every second-level k-means at once, as one masked Lloyd over the cells
    padded to a (nc1, Pmax, d) tensor (`_batched_subkmeans`)."""
    from ..ops.kmeans import ClusteringParameters, kmeans

    xt = _f32(xt)
    cp1 = ClusteringParameters(niter=clustering_niter,
                               max_points_per_centroid=2000)
    if verbose:
        print(f"2-level clustering {xt.shape}: nc1={nc1} total nc2={nc2}")
    centroids1, _ = kmeans(xt, nc1, cp1, device=device)
    _, a1 = D.knn(_to(xt, device), _to(centroids1, device), 1)
    assign1 = a1[:, 0].cpu().numpy()
    bc = np.bincount(assign1, minlength=nc1)
    order = np.argsort(assign1, kind="stable")
    if rebalance:
        bc_sum = np.cumsum(bc)
        all_nc2 = bc_sum * nc2 // max(int(bc_sum[-1]), 1)
        all_nc2[1:] -= all_nc2[:-1]
    else:
        cc = np.arange(nc1 + 1) * nc2 // nc1
        all_nc2 = cc[1:] - cc[:-1]
    assert int(all_nc2.sum()) == nc2

    cp2 = cp or ClusteringParameters(niter=10)
    if batched:
        if rebalance or nc2 % nc1:
            raise ValueError("batched two-level clustering needs equal "
                             "cell budgets (rebalance=False, nc1 | nc2)")
        lims = np.zeros(nc1 + 1, np.int64)
        np.cumsum(bc, out=lims[1:])
        return _batched_subkmeans(xt, order, lims, nc2 // nc1, cp2.niter,
                                  cp2.seed, device)
    out: list = []
    short = 0
    i0 = 0
    for c1 in range(nc1):
        i1 = i0 + int(bc[c1])
        sub = xt[order[i0:i1]]
        i0 = i1
        k = int(all_nc2[c1])
        if k == 0:
            continue
        if len(sub) <= k:
            # a degenerate cell: every point is a centroid; the shortfall
            # comes from the whole set afterwards
            out.append(sub)
            short += k - len(sub)
            continue
        c, _ = kmeans(sub, k, cp2, device=device)
        out.append(c)
        if verbose and c1 % max(1, nc1 // 10) == 0:
            print(f"  sub-cluster {c1}/{nc1} (k={k}, n={len(sub)})")
    if short:
        rs = np.random.RandomState(cp2.seed)
        out.append(xt[rs.choice(len(xt), short, replace=False)])
    centroids = np.vstack(out).astype(np.float32)
    assert len(centroids) == nc2, (len(centroids), nc2)
    return centroids


def _batched_subkmeans(xt: np.ndarray, order: np.ndarray, lims: np.ndarray,
                       k2: int, niter: int, seed: int,
                       device) -> np.ndarray:
    """Every second-level k-means of two_level_clustering as one masked
    Lloyd: the cells padded to the largest (nc1, Pmax, d), each iteration
    one batched product, an argmin and an f32 `index_add_` of the valid
    rows into (nc1 * k2) sums. A cell's init is k2 distinct valid rows,
    the smallest keys of a seeded `torch.Generator` (the reference draws
    them with jax.random, so the two agree by objective, not bit for bit).
    An empty sub-cluster keeps its centroid. Returns (nc1 * k2, d)."""
    nc1 = len(lims) - 1
    d = xt.shape[1]
    sizes = np.diff(lims)
    Pmax = max(int(sizes.max()), k2)
    X = np.zeros((nc1, Pmax, d), np.float32)
    M = np.zeros((nc1, Pmax), bool)
    for c in range(nc1):
        s = int(sizes[c])
        X[c, :s] = xt[order[lims[c]:lims[c + 1]]]
        M[c, :s] = True
    X_d = torch.from_numpy(X).to(device)
    M_d = torch.from_numpy(M).to(device)
    gen = torch.Generator(device=X_d.device)
    gen.manual_seed(int(seed))
    keys = torch.rand((nc1, Pmax), generator=gen, device=X_d.device)
    keys = torch.where(M_d, keys, torch.inf)
    pick = torch.sort(keys, dim=1, stable=True).indices[:, :k2]
    cent = torch.gather(X_d, 1, pick[:, :, None].expand(-1, -1, d))
    base = (torch.arange(nc1, device=X_d.device) * k2)[:, None]
    valid = M_d.reshape(-1)
    rows = X_d.reshape(-1, d)[valid]
    for _ in range(niter):
        ip = torch.bmm(X_d, cent.transpose(1, 2))          # (nc1, Pmax, k2)
        dis = (cent * cent).sum(2)[:, None, :] - 2.0 * ip
        a = (torch.argmin(dis, dim=2) + base).reshape(-1)[valid]
        sums = torch.zeros((nc1 * k2, d), device=X_d.device)
        sums.index_add_(0, a, rows)
        counts = torch.bincount(a, minlength=nc1 * k2).float()
        new = sums / counts.clamp(min=1.0)[:, None]
        cent = torch.where((counts > 0)[:, None], new,
                           cent.reshape(-1, d)).reshape(nc1, k2, d)
    return cent.reshape(nc1 * k2, d).cpu().numpy()


def train_ivf_index_with_2level(index, xt, **kw) -> None:
    """Train an IVF index's coarse quantizer with two_level_clustering
    (contrib/clustering.py:95) on the index's device; handles
    IndexPreTransform chains."""
    from ..models.transforms import IndexPreTransform

    xt = _f32(xt)
    if isinstance(index, IndexPreTransform):
        for vt in index.chain:
            vt.train(xt)
            xt = _f32(vt.apply(xt))
        train_ivf_index_with_2level(index.index, xt, **kw)
        index.is_trained = True
        return
    nc1 = kw.pop("nc1", None) or int(np.sqrt(index.nlist))
    kw.setdefault("device", index.device)
    centroids = two_level_clustering(xt, nc1, index.nlist, **kw)
    index.quantizer.reset()
    index.quantizer.train(centroids)
    index.quantizer.add(centroids)
    index.quantizer_trains_alone = 1
    index.train(xt)


# ---------------------------------------------------------------------------
# invlist surgery (contrib/ivf_tools.py:60-148)
# ---------------------------------------------------------------------------

def range_search_preassigned(index_ivf, x, radius, list_nos):
    """IVF range search over caller-given probe lists
    (ivf_tools.py:60): the rows of the lists ``list_nos`` (nq, nprobe)
    within the radius, exact f32, through the index's range route."""
    from ..ops.range_search import range_search_ivf

    index_ivf._ready()
    x = index_ivf._check_input(x)
    list_nos = np.ascontiguousarray(list_nos, np.int64)
    if list_nos.shape[0] != len(x):
        raise ValueError("list_nos must have a row per query")
    _, mnb = index_ivf._effective_params(None)
    res = range_search_ivf(x, list_nos, index_ivf._range_lists(), radius,
                           index_ivf.metric_type, max_nblocks=mnb)
    return res.lims, res.distances, index_ivf._map_ids(res.labels)


def permute_invlists(index_ivf, perm) -> None:
    """Renumber the inverted lists: new list i holds old list perm[i], and
    the quantizer's centroid i moves with it (ivf_tools.py:122; search
    results do not change)."""
    perm = np.ascontiguousarray(perm, np.int64)
    nlist = index_ivf.nlist
    if perm.shape != (nlist,) or \
            not (np.bincount(perm, minlength=nlist) == 1).all():
        raise ValueError("perm is not a permutation of the lists")
    index_ivf._maybe_repack()
    cent = index_ivf.quantizer.reconstruct_n(0, nlist)[perm]
    q = index_ivf.quantizer
    q.reset()
    q.train(cent)
    q.add(cent)
    inv = np.empty(nlist, np.int64)
    inv[perm] = np.arange(nlist)
    for j, a in enumerate(index_ivf._assign_host):
        if a is not None:
            index_ivf._assign_host[j] = inv[a]
    index_ivf._repack()


def sort_invlists_by_size(index_ivf) -> np.ndarray:
    """Lay the lists out in increasing size (ivf_tools.py:145); returns
    the permutation applied."""
    perm = np.argsort(get_invlist_sizes(index_ivf), kind="stable")
    permute_invlists(index_ivf, perm)
    return perm


# ---------------------------------------------------------------------------
# DatasetAssign and the k-means loop over it (contrib/clustering.py:
# 130-283, 346)
# ---------------------------------------------------------------------------

class DatasetAssign:
    """Training data behind the minimal k-means interface: count / dim /
    get_subset / assign_to. Subclass to put the data elsewhere (another
    process over rpc, a sparse matrix). ``assign_to`` runs on ``device``:
    the exact f32 `knn` and f32 `index_add_` sums."""

    def __init__(self, x, *, device="cuda"):
        self.x = _f32(x)
        self.device = torch.device(device)

    def count(self) -> int:
        return self.x.shape[0]

    def dim(self) -> int:
        return self.x.shape[1]

    def get_subset(self, indices) -> np.ndarray:
        return self.x[np.asarray(indices)]

    def assign_to(self, centroids, weights=None):
        """(assign (n,), distances (n,), sum_per_centroid (k, d))."""
        xd = _to(self.x, self.device)
        cent = _to(centroids, self.device)
        dis, idx = D.knn(xd, cent, 1)
        a = idx[:, 0]
        if weights is not None:
            xd = xd * _to(weights, self.device)[:, None]
        sums = torch.zeros((len(cent), xd.shape[1]), device=xd.device)
        sums.index_add_(0, a, xd)
        return (a.cpu().numpy(), dis[:, 0].cpu().numpy(),
                sums.cpu().numpy())


class DatasetAssignDispatch:
    """A DatasetAssign fanned over several sub-assigners, their partial
    results summed (the client half of the reference's distributed
    k-means: contrib/clustering.py and
    benchs/distributed_ondisk/distributed_kmeans.py)."""

    def __init__(self, assigners):
        self.assigners = list(assigners)

    def count(self) -> int:
        return sum(a.count() for a in self.assigners)

    def dim(self) -> int:
        return self.assigners[0].dim()

    def get_subset(self, indices) -> np.ndarray:
        indices = np.asarray(indices)
        sizes = np.cumsum([0] + [a.count() for a in self.assigners])
        out = np.empty((len(indices), self.dim()), np.float32)
        for j, a in enumerate(self.assigners):
            m = (indices >= sizes[j]) & (indices < sizes[j + 1])
            if m.any():
                out[m] = a.get_subset(indices[m] - sizes[j])
        return out

    def assign_to(self, centroids, weights=None):
        if weights is None:
            wslices = [None] * len(self.assigners)
        else:
            weights = np.asarray(weights, np.float32)
            lims = np.cumsum([0] + [a.count() for a in self.assigners])
            wslices = [weights[lims[j]:lims[j + 1]]
                       for j in range(len(self.assigners))]
        parts = [a.assign_to(centroids, w)
                 for a, w in zip(self.assigners, wslices)]
        assign = np.concatenate([p[0] for p in parts])
        dis = np.concatenate([p[1] for p in parts])
        sums = np.sum([p[2] for p in parts], axis=0)
        return assign, dis, sums


def kmeans_assign(k: int, data, niter: int = 25, seed: int = 1234,
                  verbose: bool = False, return_stats: bool = False):
    """k-means over a DatasetAssign (contrib/clustering.py:346 ``kmeans``):
    Lloyd's with empty clusters split from the largest, the data reached
    only through the DatasetAssign interface. The host loop is the
    reference's; the device work is each assigner's."""
    n, d = data.count(), data.dim()
    rs = np.random.RandomState(seed)
    centroids = data.get_subset(rs.choice(n, size=k, replace=False))
    stats = []
    for it in range(niter):
        t0 = time.time()
        assign, dis, sums = data.assign_to(centroids)
        counts = np.bincount(assign, minlength=k)
        obj = float(dis.sum())
        # empty clusters split the largest ones (Clustering.cpp
        # split_clusters)
        nonempty = counts > 0
        centroids = np.where(nonempty[:, None],
                             sums / np.maximum(counts, 1)[:, None],
                             centroids)
        for ce in np.nonzero(~nonempty)[0]:
            big = int(np.argmax(counts))
            eps = 1.0 / 1024
            centroids[ce] = centroids[big] * (1 + eps)
            centroids[big] *= (1 - eps)
            counts[ce] = counts[big] // 2
            counts[big] -= counts[ce]
        stats.append({"obj": obj, "time": time.time() - t0,
                      "imbalance": float((counts.astype(np.float64) ** 2
                                          ).sum() * k / max(n, 1) ** 2)})
        if verbose:
            print(f"kmeans iter {it}: obj {obj:.4g}")
    if return_stats:
        return centroids, stats
    return centroids


class DatasetAssignSparse(DatasetAssign):
    """DatasetAssign over a scipy CSR matrix (contrib/clustering.py:249):
    k-means on sparse training data without densifying it, on the host
    with scipy, as in the reference — distances by the sparse-dense
    product ||x||² - 2 x·cᵀ + ||c||², sums by a one-hot CSR product."""

    def __init__(self, x_csr):
        import scipy.sparse as sp

        if not sp.issparse(x_csr):
            raise TypeError("DatasetAssignSparse needs a scipy sparse "
                            "matrix (use DatasetAssign for dense)")
        self.x = x_csr.tocsr().astype(np.float32)
        self._sq_norms = np.asarray(
            self.x.multiply(self.x).sum(axis=1)).ravel()

    def count(self) -> int:
        return self.x.shape[0]

    def dim(self) -> int:
        return self.x.shape[1]

    def get_subset(self, indices) -> np.ndarray:
        return np.asarray(self.x[np.asarray(indices)].todense(), np.float32)

    def assign_to(self, centroids, weights=None):
        import scipy.sparse as sp

        centroids = _f32(centroids)
        ip = np.asarray(self.x @ centroids.T)             # (n, k) dense
        cn = (centroids * centroids).sum(axis=1)
        dis = self._sq_norms[:, None] - 2.0 * ip + cn[None, :]
        a = np.argmin(dis, axis=1)
        dmin = np.maximum(dis[np.arange(len(a)), a], 0.0)
        n, k = self.x.shape[0], len(centroids)
        w = (np.ones(n, np.float32) if weights is None
             else np.asarray(weights, np.float32))
        onehot = sp.csr_matrix((w, (a, np.arange(n))), shape=(k, n))
        sums = np.asarray((onehot @ self.x).todense(), np.float32)
        return a.astype(np.int64), dmin.astype(np.float32), sums
