"""Sharded and replicated search and clustering over `torch.distributed` —
PyTorch counterpart of `tpu_ann/parallel/sharded.py`.

The reference lays its devices on a `jax.sharding.Mesh` with the axes
("replica", "shard") and merges in-graph with XLA collectives. Here each
device is one process of the default process group, and the mesh is a
small `Mesh` object over it: rank r sits at replica r // n_shards and
shard r % n_shards (the reference's ``reshape(n_replicas, n_shards)``),
with a process group for the shards of its replica and one for the
replicas of its shard. Each function runs in every process of the world:

  shard    — a row-sharded argument is the rank's own part: its rows of
             the database (`local_rows`), or its shard's packed inverted
             lists with global row ids (faiss IndexShardsIVF: a common
             quantizer, disjoint lists);
  replica  — replicated arguments (queries, probes, centroids, codebooks)
             are whole on every rank; each function takes its replica's
             rows of the queries itself, so nq must divide by n_replicas
             (as `shard_map` requires).

The merges are the reference's: a per-rank top-k, an all-gather of the
(nq / n_replicas, k) partials over the shard group, one stable k-select in
which the lower shard wins ties (the all-gather's order), and an
all-gather over the replica group, so every rank returns the whole (nq, k)
result. Distributed k-means is one all-reduce of per-centroid (sum,
count) partials and the objective over the world.

Collectives are `dist.all_gather` in its list form and `dist.all_reduce`
on the tensors' own device: NCCL where each rank has a card of its own,
gloo otherwise (gloo moves CUDA tensors through host memory itself; NCCL
refuses two ranks on one card). With no process group (one process, a
1 x 1 mesh) every function runs with no collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import distances as D
from ..ops import topk as TK


@dataclasses.dataclass
class Mesh:
    """A (replica, shard) layout of the default process group, seen from
    one rank (see the module docstring); ``device`` holds its tensors."""

    n_shards: int
    n_replicas: int
    rank: int
    device: torch.device
    shard_group: Optional[object] = None      # the shards of my replica
    replica_group: Optional[object] = None    # the replicas of my shard
    distributed: bool = False

    @property
    def shard(self) -> int:
        return self.rank % self.n_shards

    @property
    def replica(self) -> int:
        return self.rank // self.n_shards

    @property
    def size(self) -> int:
        return self.n_shards * self.n_replicas


def make_mesh(n_shards: int, n_replicas: int = 1, device=None) -> Mesh:
    """The (replica, shard) mesh of this process. Every rank of the world
    calls it, with the same sizes; the world size must be n_shards *
    n_replicas (1 without a process group). ``device``: where the rank's
    tensors live, ``cuda:{LOCAL_RANK}`` by default; "cpu" only when the
    caller asks for it."""
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    need = n_shards * n_replicas
    if n_shards < 1 or n_replicas < 1 or world != need:
        raise ValueError(f"need {need} processes, have {world}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    mesh = Mesh(n_shards, n_replicas, dist.get_rank() if distributed else 0,
                device, distributed=distributed)
    if device.type == "cuda":
        torch.cuda.set_device(mesh.device)     # NCCL's device for this rank
    if distributed:
        # every rank creates every group, in the same order
        for r in range(n_replicas):
            g = dist.new_group(list(range(r * n_shards, (r + 1) * n_shards)))
            if r == mesh.replica:
                mesh.shard_group = g
        for s in range(n_shards):
            g = dist.new_group(list(range(s, need, n_shards)))
            if s == mesh.shard:
                mesh.replica_group = g
    return mesh


def shard_rows(x: np.ndarray, n_shards: int) -> np.ndarray:
    """Pad rows to a multiple of n_shards (rows of 0) so the array can be
    evenly row-sharded (the valid count is the caller's ``len(x)``)."""
    n = x.shape[0]
    pad = (-n) % n_shards
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x


def local_rows(x, mesh: Mesh, axis: str = "shard"):
    """This rank's part of an evenly row-sharded global array (a
    `shard_rows`-padded one): block ``mesh.shard`` of n_shards for
    ``axis="shard"`` (the database rows of `sharded_knn` /
    `sharded_refine`), block ``mesh.rank`` of the world for
    ``axis="world"`` (the training rows of `sharded_kmeans_iter`) — the
    reference's PartitionSpec("shard") and (("replica", "shard"))."""
    parts, i = ((mesh.n_shards, mesh.shard) if axis == "shard"
                else (mesh.size, mesh.rank))
    if x.shape[0] % parts:
        raise ValueError(f"{x.shape[0]} rows do not split into {parts}")
    n = x.shape[0] // parts
    return x[i * n:(i + 1) * n]


def _gather(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    """[t of member 0, t of member 1, ...] of ``group`` (n members), in
    group-rank order; [t] without a process group."""
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _my_queries(mesh: Mesh, *arrays):
    """This replica's rows of each replicated (nq, ...) argument, on the
    mesh's device."""
    nq = arrays[0].shape[0]
    if nq % mesh.n_replicas:
        raise ValueError(f"nq={nq} must divide by the {mesh.n_replicas} "
                         f"replicas")
    m = nq // mesh.n_replicas
    sl = slice(mesh.replica * m, (mesh.replica + 1) * m)
    return [torch.as_tensor(a, device=mesh.device)[sl] for a in arrays]


def _merge(mesh: Mesh, d_l: torch.Tensor, i_l: torch.Tensor, k: int,
           similarity: bool):
    """The per-rank top-k partials merged over the shards (the lower shard
    wins ties), then the replicas' query rows put together: (nq, k) on
    every rank."""
    dg = torch.stack(_gather(d_l, mesh.shard_group, mesh.n_shards))
    ig = torch.stack(_gather(i_l, mesh.shard_group, mesh.n_shards))
    d_m, i_m = TK.merge_topk_axis(dg, ig, k, similarity=similarity)
    return (torch.cat(_gather(d_m, mesh.replica_group, mesh.n_replicas)),
            torch.cat(_gather(i_m, mesh.replica_group, mesh.n_replicas)))


def sharded_knn(xq, xb, k: int, metric: int = D.METRIC_L2, *, mesh: Mesh,
                valid_n: Optional[int] = None):
    """Exact k-NN with the database row-sharded over the shards and the
    queries split over the replicas (IndexShards composed with
    IndexReplicas; reference :72).

    ``xb`` is this rank's rows (`local_rows` of a `shard_rows`-padded
    database, the same count on every rank); ``valid_n`` masks the global
    padding rows. ``xq`` (nq, d) is replicated. Returns (D, I): (nq, k)
    f32 distances and int64 global row ids on every rank."""
    similarity = D.is_similarity_metric(metric)
    xq_l, = _my_queries(mesh, xq)
    xb_l = torch.as_tensor(xb, device=mesh.device).float()
    size = xb_l.shape[0]
    base = mesh.shard * size
    total = mesh.n_shards * size
    valid = total if valid_n is None else int(valid_n)
    local_valid = min(max(valid - base, 0), size)
    d_l, i_l = D.knn(xq_l.float(), xb_l, k, metric, valid_n=local_valid)
    i_l = torch.where(i_l >= 0, i_l + base, -1)
    return _merge(mesh, d_l, i_l, k, similarity)


def sharded_kmeans_iter(x, centroids, k: int, metric: int = D.METRIC_L2, *,
                        mesh: Mesh):
    """One distributed Lloyd iteration (reference :123): ``x`` is this
    rank's training rows (`local_rows(..., axis="world")`), ``centroids``
    (k, d) are replicated. The local assignment is exact f32 (the package
    keeps TF32 off), the per-centroid sums and counts come from
    ``index_add_``, and one all-reduce over the world sums (sums, counts,
    objective). An empty cluster keeps its centroid. Returns
    (new_centroids (k, d) f32, counts (k,) f32, obj 0-d f32), the same on
    every rank."""
    x_l = torch.as_tensor(x, device=mesh.device).float()
    cent = torch.as_tensor(centroids, device=mesh.device).float()
    d = cent.shape[1]
    dis, assign = D.knn(x_l, cent, 1, metric)
    a = assign[:, 0]
    part = torch.zeros(k * d + k + 1, device=mesh.device)
    part[:k * d].view(k, d).index_add_(0, a, x_l)
    part[k * d:k * d + k].index_add_(
        0, a, torch.ones_like(a, dtype=torch.float32))
    part[-1] = dis[:, 0].sum()
    if mesh.distributed:
        dist.all_reduce(part)
    sums = part[:k * d].view(k, d)
    counts = part[k * d:k * d + k]
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1.0)[:, None], cent)
    return new_c, counts, part[-1]


def sharded_ivf_scan(xq, probes, invlists, k: int,
                     metric: int = D.METRIC_L2, *, max_nblocks: int,
                     mesh: Mesh, fused: bool = False):
    """Sharded IVF list scan (reference :174): every rank holds its own
    shard's `PackedInvLists` (on the mesh's device, global row ids) over
    a row partition of the database, all under one replicated coarse
    quantizer (faiss IndexShardsIVF). ``xq`` (nq, d) and ``probes`` (nq,
    nprobe) are replicated.

    ``fused=True`` scans through `ops.ivf_scan_fused.scan_invlists_fused`
    (K3 on a CUDA device, its plain version on CPU tensors), which streams
    every probed list whole; ``fused=False`` through the query-major
    `ops.ivf_scan.scan_invlists`, whose lists are cut at ``max_nblocks``.
    Returns (D, I): (nq, k) f32 and int64 global ids on every rank."""
    from ..ops.ivf_scan import scan_invlists
    from ..ops.ivf_scan_fused import scan_invlists_fused

    similarity = D.is_similarity_metric(metric)
    xq_l, pr_l = _my_queries(mesh, xq, probes)
    if fused:
        d_l, i_l, _ = scan_invlists_fused(xq_l.float(), pr_l.long(),
                                          invlists, k, metric)
    else:
        d_l, i_l, _ = scan_invlists(xq_l.float(), pr_l.long(), invlists, k,
                                    metric, max_nblocks=max_nblocks)
    return _merge(mesh, d_l.float(), i_l.long(), k, similarity)


def sharded_ivf_scan_pq(xq, probes, coarse_dis, invlists, pq_centroids,
                        coarse_centroids, k: int, metric: int = D.METRIC_L2,
                        *, by_residual: bool = True, max_nblocks: int,
                        packed4: bool = False, mesh: Mesh):
    """Sharded ADC scan over PQ code lists (reference :251): every rank
    holds its shard's `PackedCodeInvLists` (global row ids), and shares
    the replicated coarse quantizer and PQ codebooks; the local scan is
    `ops.ivf_scan.scan_invlists_pq`. ``coarse_dis`` is taken for the
    reference's signature and, as there, not read. Returns (D, I): (nq,
    k) on every rank."""
    from ..ops.ivf_scan import scan_invlists_pq

    del coarse_dis
    similarity = D.is_similarity_metric(metric)
    xq_l, pr_l = _my_queries(mesh, xq, probes)
    books = torch.as_tensor(pq_centroids, device=mesh.device).float()
    cc = torch.as_tensor(coarse_centroids, device=mesh.device).float()
    d_l, i_l, _ = scan_invlists_pq(xq_l.float(), pr_l.long(), invlists,
                                   books, cc, k, metric,
                                   by_residual=by_residual,
                                   max_nblocks=max_nblocks, packed4=packed4)
    return _merge(mesh, d_l.float(), i_l.long(), k, similarity)


def sharded_refine(xq, cand_ids, xb, k: int, metric: int = D.METRIC_L2, *,
                   mesh: Mesh):
    """Exact re-rank of candidate ids against row-sharded f32 rows
    (IndexRefineFlat's k_factor step; reference :323). ``xb`` is this
    rank's rows (`local_rows`), ``cand_ids`` (nq, R) replicated GLOBAL
    ids, -1 for an empty slot. Each rank scores, in f32, the candidates
    whose rows it owns (the rest get the worst value); an all-gather over
    the shards takes the min (the max for IP), since each id has one
    owner; a stable top-k keeps the lower slot first on ties, and a slot
    at the worst value gets id -1. Unlike the reference (kk = min(k, R))
    the result is padded to (nq, k). Returns (D, I) on every rank."""
    similarity = D.is_similarity_metric(metric)
    worst = D.worst_value(metric)
    xq_l, cand = _my_queries(mesh, xq, cand_ids)
    xq_l = xq_l.float()
    cand = cand.long()
    xb_l = torch.as_tensor(xb, device=mesh.device).float()
    size = xb_l.shape[0]
    lid = cand - mesh.shard * size
    ok = (cand >= 0) & (lid >= 0) & (lid < size)
    rows = xb_l[lid.clamp(0, size - 1)]                 # (nq_l, R, d)
    if similarity:
        dis = torch.bmm(rows, xq_l[:, :, None])[:, :, 0]
    else:
        dif = xq_l[:, None, :] - rows
        dis = (dif * dif).sum(-1)
    dis = torch.where(ok, dis, worst)
    dg = torch.stack(_gather(dis, mesh.shard_group, mesh.n_shards))
    dis = dg.amax(0) if similarity else dg.amin(0)
    nq_l, R = cand.shape
    if R < k:
        dis = torch.cat([dis, dis.new_full((nq_l, k - R), worst)], 1)
        cand = torch.cat([cand, cand.new_full((nq_l, k - R), -1)], 1)
    d_m, i_m = TK.topk_with_ids(dis, cand, k, similarity=similarity)
    i_m = torch.where(d_m == worst, -1, i_m)
    return (torch.cat(_gather(d_m, mesh.replica_group, mesh.n_replicas)),
            torch.cat(_gather(i_m, mesh.replica_group, mesh.n_replicas)))


def kmeans_distributed(x: np.ndarray, k: int, *, mesh: Mesh, niter: int = 25,
                       seed: int = 1234, verbose: bool = False) -> np.ndarray:
    """Distributed Lloyd's loop (reference :379): every rank passes the
    same ``x``; the reference's `subsample_training_set`, padded to a
    multiple of the world size with repeats, gives the training rows, and
    ``RandomState(seed).choice`` the initial centroids. Each rank takes
    its rows (`local_rows(..., axis="world")`) and runs
    `sharded_kmeans_iter`; an empty cluster is re-seeded on the host from
    the all-reduced counts (``donors * (1 + 1e-3)``, the same on every
    rank). `InterruptCallback.check()` runs before every iteration.
    Returns the (k, d) f32 centroids."""
    from ..ops.kmeans import ClusteringParameters, subsample_training_set
    from ..utils.interrupt import InterruptCallback

    cp = ClusteringParameters(niter=niter, seed=seed)
    x = np.ascontiguousarray(x, np.float32)
    xt = subsample_training_set(x, k, cp.max_points_per_centroid, seed)
    pad = (-len(xt)) % mesh.size
    if pad:
        # pad with repeats (weightless enough at subsample scale)
        xt = np.concatenate([xt, xt[:pad]])
    rs = np.random.RandomState(seed)
    cent = torch.from_numpy(xt[rs.choice(len(xt), k, replace=False)]).to(
        mesh.device)
    x_l = torch.from_numpy(np.ascontiguousarray(
        local_rows(xt, mesh, axis="world"))).to(mesh.device)
    for it in range(niter):
        InterruptCallback.check()
        cent, counts, obj = sharded_kmeans_iter(x_l, cent, k, mesh=mesh)
        counts_h = counts.cpu().numpy()
        empty = np.nonzero(counts_h == 0)[0]
        if len(empty):
            cent_h = cent.cpu().numpy()
            donors = np.argsort(-counts_h)[:len(empty)]
            cent_h[empty] = cent_h[donors] * (1 + 1e-3)
            cent = torch.from_numpy(cent_h).to(mesh.device)
        if verbose:
            print(f"  distributed kmeans iter {it}: obj={float(obj):.4g} "
                  f"empty={len(empty)}")
    return cent.cpu().numpy()


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, *,
                         timeout_s: float = 300.0) -> None:
    """Multi-process bring-up (reference :422, the role of the reference
    fork's Slurm parsing): `dist.init_process_group` at
    ``tcp://{coordinator}`` ("host:port") with ``num_processes`` ranks, this
    one ``process_id``; an argument left None comes from torchrun's
    environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK). The backend
    is NCCL unless the caller asks for "gloo"; ``timeout_s`` bounds every
    collective, so a lost peer raises instead of hanging. No-op when a
    process group exists already, or when there is neither a coordinator
    nor torchrun's environment (one process)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator is None and "MASTER_ADDR" not in env:
        return
    if coordinator is None:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    dist.init_process_group(
        backend=backend or "nccl", init_method=f"tcp://{coordinator}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
