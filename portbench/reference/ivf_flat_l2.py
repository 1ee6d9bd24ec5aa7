"""Plain PyTorch reference of an IVF-Flat search under the L2 metric.

No kernel, no cache, no batching of the program: blocks of queries against
every base row, exact on integer-valued data such as SIFT's (see
``IVFFlatL2``). It imports nothing of the program.

What it works out, from the benchmark's own base rows, queries and training
rows alone:
- the coarse centroids, by plain Lloyd k-means from the seed (``kmeans``):
  the table that the benchmark hands to the program's index as a trained
  quantizer, so that both sides search the same lists;
- each base row's inverted list (its nearest centroid);
- each query's probed lists (its ``nprobe`` nearest centroids);
- the IVF answer: the k smallest distances over the rows of the probed
  lists, ascending, with their row ids, as the two bounds that float32's
  ties allow (see ``Answers``);
- the exact answer over all base rows (its k-th distance, for recall);
- the gain of one more Lloyd step from a set of centroids on the training
  rows (the check of the program's own training).

``tf32=True`` computes every product in float32 with TF32 allowed: the
control, one precision below the float32 that the configuration states.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on (the control) or off (the reference) for the block, then
    the caller's settings back."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def sq_l2(xq: torch.Tensor, xb: torch.Tensor,
          xb_norms: torch.Tensor = None) -> torch.Tensor:
    """(nq, nb) squared L2 distances by the expansion, clamped at 0."""
    if xb_norms is None:
        xb_norms = (xb * xb).sum(1)
    d = (xq * xq).sum(1, keepdim=True) + xb_norms[None, :] - 2.0 * (xq @ xb.T)
    return d.clamp_(min=0.0)


def nearest(x: torch.Tensor, cent: torch.Tensor, n: int):
    """(distances, ids) of each row's n nearest centroids, nearest first,
    both (len(x), n)."""
    dist = torch.empty((x.shape[0], n), dtype=x.dtype, device=x.device)
    ids = torch.empty((x.shape[0], n), dtype=torch.long, device=x.device)
    cn = (cent * cent).sum(1)
    block = max(256, (1 << 28) // cent.shape[0])
    for i0 in range(0, x.shape[0], block):
        v, i = torch.topk(sq_l2(x[i0:i0 + block], cent, cn), n, dim=1,
                          largest=False, sorted=True)
        dist[i0:i0 + block], ids[i0:i0 + block] = v, i
    return dist, ids


@dataclasses.dataclass
class Answers:
    """IVF answers of a query set, and the exact k-th distance.

    A row whose two nearest centroids lie within the tolerance of each other
    may sit in either list, and a list that lies within it of a query's
    nprobe-th nearest may or may not be probed: computed in float32, as the
    configuration states, either choice is sound. ``low_d`` is the k best
    distances over every row that may be probed, ``high_d`` over the rows
    that are probed whichever way those ties fall; a sound answer's k-th
    distance at each rank lies between the two. Without ties they are
    equal."""

    low_d: torch.Tensor    # (nq, k) ascending, over rows that may be probed
    high_d: torch.Tensor   # (nq, k) ascending, over rows probed for sure
    ivf_i: torch.Tensor    # (nq, k) the rows of high_d
    exact_kth: torch.Tensor  # (nq,) k-th smallest distance over all rows
    probes: torch.Tensor   # (nq, nprobe) probed lists, nearest first


class IVFFlatL2:
    """The reference over base rows ``xb`` (on the device it computes on)
    and centroids ``cent``.

    Distances to centroids are float64 (float32 in the control). Distances
    to base rows are float32 products with TF32 off, ranked as ||x||^2 -
    2 q.x (||q||^2 is the same for every row of a query, so it is added to
    the k kept values only); on rows of byte values (0 to 255) in 128
    dimensions every term and partial sum is an integer below 2^24, exact
    in float32.

    ``rel_tol`` sets the ties: two distances to centroids from a vector v
    tie when they differ by at most rel_tol * (||v||^2 + the largest
    ||c||^2), the scale of float32's round-off of the expansion ||v||^2 -
    2 v.c + ||c||^2 (2^-24 of each term). The control takes 0."""

    def __init__(self, xb: torch.Tensor, cent: torch.Tensor, *,
                 tf32: bool = False, rel_tol: float = 1e-6):
        self.tf32 = tf32
        self.rel_tol = rel_tol
        self.cdtype = torch.float32 if tf32 else torch.float64
        self.xb = xb.float()
        self.xb_norms = (self.xb * self.xb).sum(1)
        self.cent = cent.to(device=xb.device, dtype=self.cdtype)
        self.cmax = float((self.cent * self.cent).sum(1).max())
        with matmul_precision(tf32):
            dist, ids = nearest(xb.to(self.cdtype), self.cent, 2)
        self.assign = ids[:, 0]
        tol = rel_tol * (self.xb_norms.to(self.cdtype) + self.cmax)
        # rows that may sit in their second list, and that list
        self.tied = torch.nonzero(dist[:, 1] - dist[:, 0] < tol)[:, 0]
        self.tied_list = ids[self.tied, 1]

    def _probed(self, cd: torch.Tensor, ids: torch.Tensor, nprobe: int,
                qn: torch.Tensor):
        """(maybe, surely) probed (nq, nlist) masks from the nprobe + 1
        nearest centroids' distances ``cd`` and ids."""
        nq, nlist = cd.shape[0], self.cent.shape[0]
        tol = self.rel_tol * (qn + self.cmax)
        maybe = cd < (cd[:, nprobe - 1:nprobe] + tol)
        surely = cd < (cd[:, nprobe:nprobe + 1] - tol) if \
            cd.shape[1] > nprobe and self.rel_tol else torch.ones_like(maybe)
        maybe[:, :nprobe] = True
        surely[:, nprobe:] = False
        out = []
        for m in (maybe, surely):
            p = torch.zeros((nq, nlist), dtype=torch.bool, device=cd.device)
            out.append(p.scatter_(1, ids, m))
        return out

    def answers(self, xq: torch.Tensor, k: int, nprobe: int,
                q_block: int = 1024) -> Answers:
        xq = xq.to(self.xb.device).float()
        nq = xq.shape[0]
        out = {n: torch.empty((nq, k), dtype=torch.float64, device=xq.device)
               for n in ("low", "high")}
        ivf_i = torch.empty((nq, k), dtype=torch.long, device=xq.device)
        kth = torch.empty(nq, dtype=torch.float64, device=xq.device)
        nc = min(nprobe + 1, self.cent.shape[0])
        with matmul_precision(self.tf32):
            cd, cids = nearest(xq.to(self.cdtype), self.cent, nc)
            for i0 in range(0, nq, q_block):
                q = xq[i0:i0 + q_block]
                qn = (q.double() ** 2).sum(1, keepdim=True)
                maybe, surely = self._probed(
                    cd[i0:i0 + q_block], cids[i0:i0 + q_block], nprobe,
                    qn.to(self.cdtype))
                d = torch.addmm(self.xb_norms[None, :], q, self.xb.T,
                                alpha=-2.0)
                kth[i0:i0 + q_block] = (torch.topk(
                    d, k, dim=1, largest=False, sorted=True)[0][:, -1:]
                    .double() + qn)[:, 0].clamp(min=0.0)
                # surely: the row's list, and its tied list, surely probed;
                # maybe: either of them maybe probed
                sure = surely[:, self.assign]
                sure[:, self.tied] &= surely[:, self.tied_list]
                v, i = torch.topk(torch.where(sure, d, float("inf")), k,
                                  dim=1, largest=False, sorted=True)
                del sure
                out["high"][i0:i0 + q_block] = (v.double() + qn).clamp(min=0)
                ivf_i[i0:i0 + q_block] = torch.where(torch.isinf(v), -1, i)
                may = maybe[:, self.assign]
                may[:, self.tied] |= maybe[:, self.tied_list]
                d.masked_fill_(~may, float("inf"))
                del may
                v = torch.topk(d, k, dim=1, largest=False, sorted=True)[0]
                out["low"][i0:i0 + q_block] = (v.double() + qn).clamp(min=0)
        return Answers(out["low"], out["high"], ivf_i, kth,
                       cids[:, :nprobe])


def row_distances(xq: torch.Tensor, xb: torch.Tensor, ids: torch.Tensor,
                  block: int = 4096) -> torch.Tensor:
    """(n, k) float64 squared distance of query row r to base row
    ids[r, j], computed directly as the sum of squared differences; inf
    where the id is not a base row."""
    n, k = ids.shape
    out = torch.full((n, k), float("inf"), dtype=torch.float64,
                     device=ids.device)
    valid = (ids >= 0) & (ids < xb.shape[0])
    for i0 in range(0, n, block):
        v = valid[i0:i0 + block]
        rows = xb[ids[i0:i0 + block].clamp(0, xb.shape[0] - 1)].double()
        q = xq[i0:i0 + block].double()[:, None, :]
        d = ((rows - q) ** 2).sum(-1)
        out[i0:i0 + block] = torch.where(v, d, out[i0:i0 + block])
    return out


def kmeans(xt: torch.Tensor, nlist: int, niter: int, seed: int
           ) -> torch.Tensor:
    """(nlist, d) float32 centroids of the training rows ``xt`` by plain
    Lloyd k-means: ``nlist`` distinct rows drawn from ``seed`` by a
    ``torch.Generator`` on ``xt``'s device, then ``niter`` steps of assign
    (float64 distances) and update (float64 means; an empty cluster keeps
    its centroid). On integer-valued rows every sum is exact, so the same
    seed and rows on the same device give the same table."""
    x = xt.double()
    gen = torch.Generator(device=x.device)
    gen.manual_seed((int(seed) + 1) % (1 << 63))
    c = x[torch.randperm(len(x), generator=gen, device=x.device)[:nlist]]
    with matmul_precision(False):
        for _ in range(niter):
            a = nearest(x, c, 1)[1][:, 0]
            sums = torch.zeros_like(c).index_add_(0, a, x)
            cnt = torch.bincount(a, minlength=nlist).double()
            c = torch.where(cnt[:, None] > 0,
                            sums / cnt.clamp(min=1)[:, None], c)
    return c.float()


def kmeans_step_gain(xt: torch.Tensor, cent: torch.Tensor) -> float:
    """Relative drop of the k-means objective on the training rows ``xt``
    by one more Lloyd step (assign, update, assign) from ``cent``: near 0
    for centroids that k-means has trained, large for centroids that
    never moved. Empty clusters keep their centroid."""
    x = xt.double()
    c = cent.to(device=x.device, dtype=torch.float64)
    with matmul_precision(False):
        a = nearest(x, c, 1)[1][:, 0]
        obj0 = ((x - c[a]) ** 2).sum()
        sums = torch.zeros_like(c).index_add_(0, a, x)
        cnt = torch.bincount(a, minlength=c.shape[0]).double()
        c1 = torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1)[:, None],
                         c)
        a1 = nearest(x, c1, 1)[1][:, 0]
        obj1 = ((x - c1[a1]) ** 2).sum()
    return float((obj0 - obj1) / obj0)
