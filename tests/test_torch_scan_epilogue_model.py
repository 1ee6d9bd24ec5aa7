"""A numpy model of the per-pair top-kp epilogue of the IVF scan kernels
above kp 64 (`update_list`, `sort_list` and `merge32` in
tpu_ann_torch/csrc/ivf_scan_core.cuh), held against a stable sort.

The model does what the kernel does, in its order: each pair's rows come
in chunks of 64 from its range's first row; a row is a candidate if it is
real and its distance is below the list's threshold (+inf until the list
holds kp entries). A list that is not full keeps its entries unsorted and
takes the candidates appended in stream order; the first time it reaches
kp it is sorted once (runs of 32 from its head, each merged into the
sorted entries before it) and its threshold becomes entry kp - 1;
candidates that would pass kp are merged into the sorted entries, the
chunk's first 32 rows, then the rest: each candidate to its rank in the
list plus the candidates before it, each entry to its index plus the
candidates before it, walking the list in blocks of 32 slots from its
tail and stopping after the first block with no candidate below it. A
list that never fills is sorted at the end. A window of the out-of-core scan
starts from the running list of the earlier windows, and only a pair with
rows in the window takes part.

The result must be the first kp of the pair's real rows ordered by
(distance, stream position), empty slots (+inf, -1): random and tie-heavy
distances, kp 33 to 1030, lists of 1 to 20 chunks, windows that split
lists. It runs on the CPU and needs no card."""

import numpy as np
import pytest

CR = 64     # rows a chunk
INF = np.float32(np.inf)


def _before(d1, p1, d2, p2):
    return (d1 < d2) | ((d1 == d2) & (p1 < p2))


def merge32(d, p, nf, cap, cd, cp):
    """`merge32`: merges the candidates (cd, cp) (at most 32, any order)
    into the sorted list of nf entries in place, keeping its first cap;
    returns the new count. r: each candidate's list entries before it;
    tie: the candidates of equal r before it; P(i): the candidates with
    r <= i. Entry i moves to i + P(i), a candidate to r + P(r - 1) + tie;
    blocks of 32 slots from the one holding slot nf, down to the first
    with no candidate below it."""
    m = len(cd)
    r = _before(d[:nf, None], p[:nf, None], cd[None], cp[None]).sum(0)
    tie = ((r[:, None] == r[None]) & _before(cd[None], cp[None], cd[:, None],
                                            cp[:, None])).sum(1)
    for b in range(nf & ~31, -1, -32):
        e = min(b + 32, nf)
        bd, bp = d[b:e].copy(), p[b:e].copy()
        below = int((r < b).sum())
        P = (r[None] <= np.arange(b, b + 32)[:, None]).sum(1)
        i = np.arange(b, e)
        Pi = P[:e - b]
        w = (Pi > 0) & (i + Pi < cap)
        d[(i + Pi)[w]], p[(i + Pi)[w]] = bd[w], bp[w]
        here = (r >= b) & (r < b + 32)
        pm1 = np.where(r > b, P[np.clip(r - b - 1, 0, 31)], below)
        o = r + pm1 + tie
        w = here & (o < cap)
        d[o[w]], p[o[w]] = cd[w], cp[w]
        if below == 0:
            break
    return min(nf + m, cap)


def sort_list(d, p, n):
    """`sort_list` on slots [0, n) of d / p, in place: runs of 32 from the
    head, each merged into the sorted slots before it (merge32)."""
    for b in range(0, n, 32):
        m = min(32, n - b)
        merge32(d, p, b, b + m, d[b:b + m].copy(), p[b:b + m].copy())


def update_list(d, p, st, cd, cp, kp, half):
    """`update_list`: one chunk's candidates (stream order; the first
    `half` of them from its first 32 rows) into a list."""
    nf, m = st["n"], len(cd)
    if nf + m > kp:
        if nf < kp:
            sort_list(d, p, nf)
        if half:
            nf = merge32(d, p, nf, kp, cd[:half], cp[:half])
        if m > half:
            merge32(d, p, nf, kp, cd[half:], cp[half:])
        st["thr"], st["n"] = d[kp - 1], kp
        return
    d[nf:nf + m], p[nf:nf + m] = cd, cp
    if nf + m == kp:
        sort_list(d, p, kp)
        st["thr"] = d[kp - 1]
    st["n"] = nf + m


def scan_pair(dist, valid, lo, hi, kp, run=None):
    """One kernel call on one pair over stream rows [lo, hi) (a window's
    clamp of its range): returns the list (kp distances, positions), or
    the running list untouched if the range is empty."""
    if run is None:
        run = (np.full(kp, INF, np.float32), np.full(kp, -1, np.int64))
    if hi <= lo:
        return run
    d, p = run[0].copy(), run[1].copy()
    nf = int(np.isfinite(d).sum())
    st = {"n": nf, "thr": d[kp - 1] if nf == kp else INF}
    for c0 in range(lo, hi, CR):
        rows = np.arange(c0, min(c0 + CR, hi))
        ok = valid[rows] & (dist[rows] < st["thr"])
        if ok.any():
            update_list(d, p, st, dist[rows][ok], rows[ok], kp,
                        int(ok[:32].sum()))
    if st["n"] < kp:
        sort_list(d, p, st["n"])
    d[st["n"]:], p[st["n"]:] = INF, -1
    return d, p


def expected(dist, valid, lo, hi, kp):
    rows = np.arange(lo, hi)[valid[lo:hi]]
    o = np.lexsort((rows, dist[rows]))[:kp]
    d = np.full(kp, INF, np.float32)
    p = np.full(kp, -1, np.int64)
    d[:len(o)], p[:len(o)] = dist[rows][o], rows[o]
    return d, p


def _stream(rs, n, ties):
    dist = (rs.randint(0, 4, n) if ties else rs.rand(n)).astype(np.float32)
    valid = rs.rand(n) > 0.1
    return dist, valid


@pytest.mark.parametrize("n", list(range(1, 70)) + [95, 96, 97, 127, 128,
                                                     129, 200, 256, 257,
                                                     511, 700, 1024, 1025,
                                                     1094, 2100])
@pytest.mark.parametrize("ties", [False, True])
def test_sort_list_sorts(n, ties):
    rs = np.random.RandomState(n * 2 + ties)
    d = (rs.randint(0, 3, n) if ties else rs.rand(n)).astype(np.float32)
    p = rs.permutation(n).astype(np.int64)
    o = np.lexsort((p, d))
    want_d, want_p = d[o], p[o]
    sort_list(d, p, n)
    assert np.array_equal(d, want_d) and np.array_equal(p, want_p)


@pytest.mark.parametrize("kp", [33, 64, 65, 106, 262, 1030])
@pytest.mark.parametrize("ties", [False, True])
def test_lists_equal_stable_sort(kp, ties):
    """K3: 200 pairs a case, ranges of 1 to 20 chunks from any row."""
    rs = np.random.RandomState(kp * 2 + ties)
    dist, valid = _stream(rs, 20 * CR + 100, ties)
    for _ in range(200):
        lo = rs.randint(0, 100)
        hi = lo + rs.choice([rs.randint(1, CR + 1),
                             rs.randint(1, 20 * CR + 1)])
        got = scan_pair(dist, valid, lo, hi, kp)
        want = expected(dist, valid, lo, hi, kp)
        assert np.array_equal(got[0], want[0]), (lo, hi)
        assert np.array_equal(got[1], want[1]), (lo, hi)


@pytest.mark.parametrize("kp", [33, 65, 106, 262, 1030])
@pytest.mark.parametrize("ties", [False, True])
def test_windows_equal_stable_sort(kp, ties):
    """K4: 150 pairs a case, each range cut by 1 to 6 windows (a window's
    rows of the range may be empty, or part of a chunk); the running list
    of each pair is what the earlier windows left."""
    rs = np.random.RandomState(1000 + kp * 2 + ties)
    dist, valid = _stream(rs, 16 * CR + 100, ties)
    for _ in range(150):
        lo = rs.randint(0, 100)
        hi = lo + rs.randint(1, 16 * CR + 1)
        cuts = np.sort(rs.randint(0, 16 * CR + 100, rs.randint(0, 6)))
        edges = [0, *cuts.tolist(), 16 * CR + 100]
        run = None
        for w0, w1 in zip(edges[:-1], edges[1:]):
            run = scan_pair(dist, valid, max(lo, w0), min(hi, w1), kp, run)
        want = expected(dist, valid, lo, hi, kp)
        assert np.array_equal(run[0], want[0]), (lo, hi, edges)
        assert np.array_equal(run[1], want[1]), (lo, hi, edges)
