"""Faults planted in the program underneath the harness, to show that the
comparison catches them (the CPU tests, and the readings the limits are
set from). Each is a context manager that patches the port's class or
function and restores it on exit.

- ``stale``: a search that returns the previous call's answers (the
  state left unchanged);
- ``half``: a search that answers the first half of the batch and hands
  the second half the first half's answers;
- ``altered``: a search whose answers come back with one id altered;
- ``one_query``: a search that answers the first query of each batch
  without its nearest row (its ranks 2 to k + 1): valid ids at their true
  distances, one wrong answer a batch;
- ``kmeans_unchanged``: k-means iterations that leave the centroids as
  they were drawn (training that returns its state unchanged).
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(owner, name: str, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def _search_patch(make):
    from tpu_ann_torch.models.ivf import IndexIVF

    return _patched(IndexIVF, "search", make)


def stale():
    def make(search):
        prev = []

        def wrapped(self, x, k, **kw):
            out = search(self, x, k, **kw)
            prev.append(out)
            return prev.pop(0) if len(prev) > 1 else out
        return wrapped
    return _search_patch(make)


def half():
    def make(search):
        def wrapped(self, x, k, **kw):
            h = (len(x) + 1) // 2
            d, i = search(self, x[:h], k, **kw)
            return (np.concatenate([d, d])[:len(x)],
                    np.concatenate([i, i])[:len(x)])
        return wrapped
    return _search_patch(make)


def altered():
    def make(search):
        def wrapped(self, x, k, **kw):
            d, i = search(self, x, k, **kw)
            i = i.copy()
            i[0, 0] = (i[0, 0] + 1) % self.ntotal
            return d, i
        return wrapped
    return _search_patch(make)


def one_query():
    def make(search):
        def wrapped(self, x, k, **kw):
            d, i = search(self, x, k, **kw)
            d1, i1 = search(self, x[:1], k + 1, **kw)
            d, i = d.copy(), i.copy()
            d[0], i[0] = d1[0, 1:], i1[0, 1:]
            return d, i
        return wrapped
    return _search_patch(make)


def kmeans_unchanged():
    from tpu_ann_torch.ops import kmeans

    def make(step):
        def wrapped(x, centroids, *args, **kw):
            _, stats = step(x, centroids, *args, **kw)
            return centroids, stats
        return wrapped
    return _patched(kmeans, "_kmeans_iter", make)


SEARCH_FAULTS = {"stale": stale, "half": half, "altered": altered,
                 "one_query": one_query}
