"""Port parity: tpu_ann_torch.utils.factory against the JAX package's
factory: the same class and parameters per spec, every token of the
reference's grammar included (NSG, LSH), reverse_index_factory round
trips, get_code_size and get_hnsw_M agree, and a token neither package
knows raises ValueError. The binary factory is in test_torch_binary.py."""

import pytest

import tpu_ann_torch as T
from tpu_ann.utils import factory as JF
from tpu_ann_torch.utils import factory as TF

D = 32
PORTED = ["Flat", "SQ8", "SQ6", "SQ4", "SQfp16", "SQbf16", "HNSW32",
          "HNSW16,Flat", "HNSW", "IVF64,Flat", "IVF64", "IVF64_HNSW16,Flat",
          "IVF64,SQ8", "IVF64_HNSW8,SQ8", "IVF64,SQ4", "IVF64,SQ6",
          "IVF64,SQfp16", "IVF64,SQbf16", "IVF64_HNSW8,SQ4",
          "PQ8", "PQ8x4", "PQ16x4fs", "PQ8x6", "IVF64,PQ8", "IVF64,PQ8x4fs",
          "IVF64,PQ16x4", "IVF64,PQ8x4fs_32", "IVF64_HNSW16,PQ8",
          "IVF64,PQ8+16", "IVF64_HNSW8,PQ4+8", "IVF64,PQ8,RFlat",
          "Flat,RFlat", "IVF64,SQ8,RSQ8t", "IVF64,PQ8,Refine(Flat)",
          "PQ8,Refine(SQ8Tier)", "IVF64_HNSW16,PQ8+4,RFlat",
          "IVF64,Flat,RFlat", "IVF64,PQ4x4fs", "HNSW32,SQ8", "HNSW16,SQfp16",
          "HNSW8,SQbf16", "HNSW32,PQ8", "HNSW16,PQ8x6", "HNSW32,PQ8,RFlat"]
# the additive codes and coarse quantizers are L2 only (ST_norm_float)
PORTED_L2 = ["RQ4x6", "LSQ4x8", "PRQ2x2x8", "PLSQ4x2x6", "IVF64,RQ4x6",
             "IVF64_HNSW8,LSQ2x8", "IVF64,PRQ2x4x8", "IVF64,PLSQ2x2x4",
             "IVF64(RCQ2x3),RQ4x4", "IVF64(LSCQ3x2),PQ8",
             "IVF64(RCQ2x3),SQ8", "IVF256(RCQ2x4),PRQ2x2x6,RFlat"]


def _params(idx) -> dict:
    out = {"class": type(idx).__name__, "d": idx.d,
           "metric": idx.metric_type}
    for name in ("nlist", "qtype", "block_size", "M", "nbits",
                 "M_refine", "nbits_refine", "k_factor", "storage_dtype",
                 "pq_m", "R", "GK", "rotate_data", "train_thresholds"):
        if hasattr(idx, name):
            out[name] = getattr(idx, name)
    if "PQ" in out["class"] and hasattr(idx, "nlist"):
        out["by_residual"] = idx.by_residual
    if hasattr(idx, "hnsw"):
        out["M"] = idx.hnsw.M
    for name in ("quantizer", "base_index", "refine_index"):
        sub = getattr(idx, name, None)
        if sub is not None:
            out[name] = _params(sub)
    return out


@pytest.mark.parametrize("metric", [T.METRIC_L2, T.METRIC_INNER_PRODUCT])
@pytest.mark.parametrize("spec", PORTED)
def test_same_class_and_parameters(spec, metric):
    _same_class_and_parameters(spec, metric)


@pytest.mark.parametrize("spec", PORTED_L2)
def test_same_class_and_parameters_l2(spec):
    """The additive codes, flat and IVF (the IVF over a coarse quantizer
    trains it alone), and their reverse specs."""
    _same_class_and_parameters(spec, T.METRIC_L2)
    t = TF.index_factory(D, spec, device="cpu")
    rev = TF.reverse_index_factory(t)
    assert _params(TF.index_factory(D, rev, device="cpu")) == _params(t)
    if "(" in spec:
        assert getattr(t, "base_index", t).quantizer_trains_alone == 1


def _same_class_and_parameters(spec, metric):
    t = TF.index_factory(D, spec, metric, device="cpu")
    j = JF.index_factory(D, spec, metric)
    assert _params(t) == _params(j)
    assert t.device.type == "cpu"
    assert TF.get_code_size(D, spec) == JF.get_code_size(D, spec)
    if hasattr(t, "hnsw"):
        assert TF.get_hnsw_M(t) == JF.get_hnsw_M(j)


@pytest.mark.parametrize("spec", PORTED)
def test_reverse_round_trip(spec):
    t = TF.index_factory(D, spec, device="cpu")
    rev = TF.reverse_index_factory(t)
    assert rev == JF.reverse_index_factory(JF.index_factory(D, spec))
    again = TF.index_factory(D, rev, device="cpu")
    assert _params(again) == _params(t)


def test_built_index_trains_and_searches():
    import numpy as np

    rs = np.random.RandomState(0)
    x = rs.rand(2000, D).astype(np.float32)
    idx = TF.index_factory(D, "IVF16_HNSW8,Flat", device="cpu")
    idx.cp.niter = 3
    idx.train(x)
    idx.add(x)
    idx.nprobe = 16
    _, I = idx.search(x[:5], 1)
    assert (I[:, 0] == np.arange(5)).all()


def _inner(idx):
    """The index under IDMap / IndexPreTransform wrappers."""
    while hasattr(idx, "index"):
        idx = idx.index
    return idx


@pytest.mark.parametrize("spec,item", [
    ("IDMap,RQ4x8,RFlat", "item 9"),
    ("IDMap,NSG32", "item 9"), ("PCA16,IVF64(RCQ2x3),Flat", "item 9"),
    ("OPQ8_16,LSQ4x8", "item 9"), ("L2norm,LSH", "item 9"),
    ("IDMap2,PRQ2x4x8", "item 9"),
    ("RQ4x8", "item 9"), ("NSG32", "item 9"), ("LSH", "item 9"),
    ("IVF64(RCQ2x3),Flat", "item 9"), ("ZnLattice4x10_4", "item 9")])
def test_unported_specs_raise(spec, item):
    """No longer a refusal test: it keeps the name it had while the port
    refused these specs, and now checks that they build. The specs that
    ROADMAP queue 1's ``item`` ported: the
    NSG, LSH, additive, coarse and lattice specs build the reference's
    classes, wrapper for wrapper, with the same parameters and code size,
    and reverse to themselves (LSH's nbits written out: "LSH" reverses to
    "LSH32")."""
    j = JF.index_factory(D, spec)     # a spec of the reference's grammar
    t = TF.index_factory(D, spec, device="cpu")
    a, b = t, j
    while True:
        assert type(a).__name__ == type(b).__name__
        if not hasattr(b, "index"):
            break
        a, b = a.index, b.index
    assert _params(a) == _params(b)
    while hasattr(b, "base_index"):          # a refine wrapper's codec
        a, b = a.base_index, b.base_index
    if "NSG" not in spec:                     # a flat NSG has no codec
        assert a.sa_code_size() == b.sa_code_size()
    if hasattr(b, "quantizer"):
        assert (a.quantizer.M, a.quantizer.nbits, a.quantizer_trains_alone) \
            == (b.quantizer.M, b.quantizer.nbits, b.quantizer_trains_alone)
    assert TF.reverse_index_factory(t) == spec.replace("LSH", f"LSH{D}")
    assert _params(_inner(TF.index_factory(D, spec, device="cpu"))) == \
        _params(_inner(t))


@pytest.mark.parametrize("metric", [T.METRIC_L2, T.METRIC_INNER_PRODUCT])
@pytest.mark.parametrize("spec", ["HNSW32,4096+PQ16", "HNSW,64+PQ8"])
def test_hnsw_2level_spec(spec, metric):
    """HNSW<M>,<n>+PQ<m> builds the reference's IndexHNSW2Level with the
    same codec shape. The reference's reverse spec says "HNSW<M>", which
    builds another class; the port's names the codec. Neither package
    gives it a code size."""
    t = TF.index_factory(D, spec, metric, device="cpu")
    j = JF.index_factory(D, spec, metric)
    assert isinstance(t, T.IndexHNSW2Level)
    assert _params(t) == _params(j)
    for a, b in ((t.codec, j.codec), (t.codec.q1, j.codec.q1)):
        assert _params(a) == _params(b)
    rev = TF.reverse_index_factory(t)
    assert JF.reverse_index_factory(j) == rev.split(",")[0]
    again = TF.index_factory(D, rev, metric, device="cpu")
    assert _params(again) == _params(t) and \
        _params(again.codec) == _params(t.codec)
    for f in (TF.get_code_size, JF.get_code_size):
        with pytest.raises(ValueError):
            f(D, spec)


@pytest.mark.parametrize("spec", ["", "Foo", "IVF64,Bar", "HNSW32,Baz"])
def test_unknown_specs_raise_value_error(spec):
    with pytest.raises(ValueError):
        JF.index_factory(D, spec)
    with pytest.raises(ValueError):
        TF.index_factory(D, spec, device="cpu")


def test_flat_dedup_spec():
    """IVF<n>,FlatDedup builds the reference's class; its reverse spec
    names FlatDedup (the reference's says Flat, which builds another
    class), and neither package gives it a code size."""
    t = TF.index_factory(D, "IVF64,FlatDedup", device="cpu")
    j = JF.index_factory(D, "IVF64,FlatDedup")
    assert isinstance(t, T.IndexIVFFlatDedup)
    assert _params(t) == {**_params(j), "class": "IndexIVFFlatDedup"}
    rev = TF.reverse_index_factory(t)
    assert rev == "IVF64,FlatDedup"
    assert type(TF.index_factory(D, rev, device="cpu")) is type(t)
    for f in (TF.get_code_size, JF.get_code_size):
        with pytest.raises(ValueError):
            f(D, "IVF64,FlatDedup")


def test_default_device_is_cuda():
    import torch

    if torch.cuda.is_available():
        assert TF.index_factory(D, "IVF64,Flat").device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TF.index_factory(D, "IVF64,Flat")


@pytest.mark.parametrize("spec", ["PQ8np", "IVF64,PQ8np", "PQ8x4np"])
def test_pq_np_spec(spec):
    """"np" (no polysemous training) builds the plain PQ class in both
    packages; neither gives it a code size."""
    t = TF.index_factory(D, spec, device="cpu")
    j = JF.index_factory(D, spec)
    assert _params(t) == _params(j)
    for f in (TF.get_code_size, JF.get_code_size):
        with pytest.raises(ValueError):
            f(D, spec)
    assert TF.reverse_index_factory(t) == JF.reverse_index_factory(j)


def test_namesake_pq_factory_builds_and_searches():
    """IVF<n>_HNSW<M>,PQ<m>: an IndexIVFPQ over an IndexHNSWFlat
    quantizer, trained (k-means, then the graph) and searched."""
    import numpy as np

    rs = np.random.RandomState(0)
    x = rs.rand(3000, D).astype(np.float32)
    idx = TF.index_factory(D, "IVF16_HNSW8,PQ8", device="cpu")
    assert isinstance(idx, T.IndexIVFPQ)
    assert isinstance(idx.quantizer, T.IndexHNSWFlat)
    idx.cp.niter = 3
    idx.train(x)
    idx.add(x)
    idx.nprobe = 16
    _, I = idx.search(x[:20], 1)
    assert (I[:, 0] == np.arange(20)).mean() >= 0.9


@pytest.mark.parametrize("spec", ["NSG16,Flat", "NSG24,PQ8", "NSG16,PQ8x6",
                                  "NSG16,SQ8", "NSG,SQfp16", "LSH64r",
                                  "LSH20rt", "LSHt", "PCA16,LSH32r"])
def test_nsg_and_lsh_specs(spec):
    """NSG<R>[,Flat | PQ<m>[x<b>] | SQ...] and LSH[nbits][r][t] (nbits
    rounded up to whole bytes) build the reference's classes with its
    parameters; the port's reverse re-parses to the same index, and
    get_code_size counts an NSG's R edges and LSH's bytes."""
    j, t = JF.index_factory(D, spec), TF.index_factory(D, spec,
                                                       device="cpu")
    assert _params(_inner(t)) == _params(_inner(j))
    rev = TF.reverse_index_factory(t)
    assert _params(_inner(TF.index_factory(D, rev, device="cpu"))) == \
        _params(_inner(t))
    inner = _inner(t)
    if "LSH" in spec:
        assert TF.get_code_size(D, spec) == JF.get_code_size(D, spec) == \
            inner.nbits // 8
    else:
        assert TF.get_code_size(D, spec) == 4 * inner.R + (
            inner.sa_code_size() if hasattr(inner, "pq_m") or hasattr(
                inner, "qtype") else 4 * D)
