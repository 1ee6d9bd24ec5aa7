"""index_factory — spec-string index construction (faiss
`index_factory.cpp:193-901`), the port's copy of `tpu_ann/utils/factory.py`
for the index classes the port has:

  Flat                          IndexFlat
  SQ8, SQ6, SQ4, SQfp16, SQbf16 IndexScalarQuantizer
  HNSW<M>, HNSW<M>,Flat         IndexHNSWFlat (M defaults to 32)
  HNSW<M>,SQ8|SQfp16|SQbf16     IndexHNSWSQ ("sq8" / float16 / bfloat16)
  HNSW<M>,PQ<m>[x<b>]           IndexHNSWPQ
  HNSW<M>,<n>+PQ<m>             IndexHNSW2Level (Index2Layer codes)
  IVF<n>,Flat                   IndexIVFFlat over an IndexFlat quantizer
  IVF<n>_HNSW<M>,Flat           IndexIVFHNSW
  IVF<n>,SQ8|SQ6|SQ4|SQfp16|SQbf16, IVF<n>_HNSW<M>,SQ...
                                IndexIVFScalarQuantizer over an
                                IndexFlat / IndexHNSWFlat quantizer
  IVF<n>,FlatDedup              IndexIVFFlatDedup
  PQ<M>[x<b>][fs[_n]|np]        IndexPQ
  IVF<n>[_HNSW<M>],PQ<m>[x<b>][fs[_n]|np]
                                IndexIVFPQ (PQ<m>x4fs: 4-bit codes)
  IVF<n>[_HNSW<M>],PQ<m>+<m'>   IndexIVFPQR (8-bit base and refine PQ)
  RQ<M>x<b>, LSQ<M>x<b>        IndexResidualQuantizer / IndexLocalSearchQuantizer
  PRQ<n>x<M>x<b>, PLSQ<n>x<M>x<b>
                                IndexProductResidualQuantizer / ...LocalSearch...
  ZnLattice<nsq>x<r2>_<sb>      IndexLattice
  IVF<n>[_HNSW<M>],RQ<M>x<b> | LSQ... | PRQ... | PLSQ...
                                IndexIVFResidualQuantizer and its family
  IVF<n>(RCQ<M>x<b> | LSCQ<M>x<b>),<code>
                                an IVF of any code above over a
                                ResidualCoarseQuantizer /
                                LocalSearchCoarseQuantizer (ksub^M == n,
                                quantizer_trains_alone = 1)
  <any of these>,RFlat | Refine(Flat)
                                IndexRefineFlat over the index
  <any of these>,RSQ8t | Refine(SQ8Tier)
                                IndexRefineSQ8Tier over the index

  NSG<R>[,Flat | PQ<m>[x<b>] | SQ8 | SQ6 | SQ4 | SQfp16 | SQbf16]
                                IndexNSGFlat / IndexNSGPQ / IndexNSGSQ (R
                                defaults to 32)
  LSH[<nbits>][r][t]            IndexLSH (nbits defaults to d, rounded up
                                to whole bytes; r rotates, t trains the
                                thresholds)

  prefixes, before the container: PCA<d>, PCAR<d> (random rotation after),
  PCAW<d> (whitened), OPQ<M>[_<d>], RR<d>, L2norm -> an IndexPreTransform
  around the index (and its refine wrapper); IDMap, IDMap2 -> an
  IndexIDMap / IndexIDMap2 around everything (reference :172-195, 300-313)

with the same spelling as the reference, whose every token the port
builds; a token the reference does not know either (ITQ among them: the
reference's factory has no ITQ prefix) raises ValueError.
`index_binary_factory` builds the binary indexes (BFlat, BIVF<n>,
BIVF<n>_HNSW<M>, BHNSW<M>, BHash<b>, BHash<nhash>x<b>; reference
:324-352). `reverse_index_factory`, `get_code_size` and `get_hnsw_M`
cover the same classes; the reverse writes each prefix's own token back
(the reference writes PCA<d> for PCAR / PCAW, IDMap for IDMap2, drops
LSH's t, cannot reverse an NSG, and raises on L2norm).
"""

from __future__ import annotations

import re

from ..models.base import Index
from ..models.binary import (IndexBinaryFlat, IndexBinaryHash,
                             IndexBinaryHNSW, IndexBinaryIVF,
                             IndexBinaryMultiHash)
from ..models.extra import IndexLSH
from ..models.flat import IndexFlat
from ..models.hnsw import (IndexHNSW, IndexHNSW2Level, IndexHNSWFlat,
                           IndexHNSWPQ, IndexHNSWSQ)
from ..models.idmap import IndexIDMap, IndexIDMap2
from ..models.ivf import IndexIVF, IndexIVFFlat, IndexIVFFlatDedup
from ..models.ivf_hnsw import IndexIVFHNSW
from ..models.ivf_pq import IndexIVFScalarQuantizer
from ..models.ivf_pq import IndexIVFPQ, IndexIVFPQR
from ..models.lattice import IndexLattice
from ..models.nsg import IndexNSGFlat, IndexNSGPQ, IndexNSGSQ
from ..models.pq import IndexPQ, IndexScalarQuantizer
from ..models.refine import IndexRefine, IndexRefineFlat, IndexRefineSQ8Tier
from ..models.rq import (AdditiveCoarseQuantizer, IndexIVFLocalSearchQuantizer,
                         IndexIVFProductLocalSearchQuantizer,
                         IndexIVFProductResidualQuantizer,
                         IndexIVFResidualQuantizer, IndexLocalSearchQuantizer,
                         IndexProductLocalSearchQuantizer,
                         IndexProductResidualQuantizer,
                         IndexResidualQuantizer, LocalSearchCoarseQuantizer,
                         ResidualCoarseQuantizer)
from ..models.transforms import (IndexPreTransform, NormalizationTransform,
                                 OPQMatrix, PCAMatrix, RandomRotationMatrix)
from ..ops import distances as D
from ..ops import sq as SQ

_SQ_TYPES = {"SQ8": SQ.QT_8BIT, "SQ6": SQ.QT_6BIT, "SQ4": SQ.QT_4BIT,
             "SQfp16": SQ.QT_FP16, "SQbf16": SQ.QT_BF16}
_SQ_NAMES = {v: k for k, v in _SQ_TYPES.items()}
_SQ_BITS = {"SQ8": 8, "SQ6": 6, "SQ4": 4, "SQfp16": 16, "SQbf16": 16}
_HNSW_SQ = {"SQ8": "sq8", "SQfp16": "float16", "SQbf16": "bfloat16"}

_AQ = r"(RQ|LSQ)(\d+)x(\d+)(?:fs(?:_\d+)?)?"
_PAQ = r"(PRQ|PLSQ)(\d+)x(\d+)x(\d+)"
_LATTICE = r"ZnLattice(\d+)x(\d+)_(\d+)"
_IVF = r"IVF(\d+)(?:_HNSW(\d+)|\((RCQ|LSCQ)(\d+)x(\d+)\))?"
_LSH = r"LSH(\d*)(r?)(t?)"


def _unknown_token(tok: str) -> ValueError:
    return ValueError(f"index_factory: unknown token {tok!r}")


_PQ = r"PQ(\d+)(?:x(\d+))?(?:fs(?:_\d+)?|np)?"
_REFINE = {"RFlat": "RFlat", "Refine(Flat)": "RFlat", "RSQ8t": "RSQ8t",
           "Refine(SQ8Tier)": "RSQ8t"}


_PREFIX = r"IDMap2?|PCA[RW]?\d+|OPQ\d+(?:_\d+)?|RR\d+|L2norm"


def _split(spec: str):
    """(prefix tokens, container token, its code token, refine suffix
    "RFlat" / "RSQ8t" or None): a container or a suffix token of no
    grammar raises ValueError here."""
    toks = [t for t in spec.split(",") if t]
    if not toks:
        raise ValueError("empty factory spec")
    refine = _REFINE.get(toks[-1]) if len(toks) > 1 else None
    if refine:
        toks = toks[:-1]
    prefixes = []
    while toks and re.fullmatch(_PREFIX, toks[0]):
        prefixes.append(toks.pop(0))
    if not toks:
        raise ValueError(f"index_factory({spec!r}): no index container")
    if not re.fullmatch(r"HNSW\d*|NSG\d*|Flat|SQ\w+|" + "|".join(
            (_PQ, _IVF, _AQ, _PAQ, _LATTICE, _LSH)), toks[0]):
        raise _unknown_token(toks[0])
    if len(toks) > 2:
        raise _unknown_token(toks[2])
    return prefixes, toks[0], toks[1] if len(toks) > 1 else None, refine


def _transform(tok: str, d: int, device):
    """The VectorTransform of a prefix token over d input dimensions
    (reference :46-62)."""
    if m := re.fullmatch(r"PCA([RW]?)(\d+)", tok):
        return PCAMatrix(d, int(m.group(2)),
                         eigen_power=-0.5 if m.group(1) == "W" else 0.0,
                         random_rotation=m.group(1) == "R", device=device)
    if m := re.fullmatch(r"OPQ(\d+)(?:_(\d+))?", tok):
        return OPQMatrix(d, int(m.group(1)), int(m.group(2) or 0),
                         device=device)
    if m := re.fullmatch(r"RR(\d+)", tok):
        return RandomRotationMatrix(d, int(m.group(1)), device=device)
    return NormalizationTransform(d, device=device)          # L2norm


def _refined(index: Index, refine) -> Index:
    if refine == "RFlat":
        return IndexRefineFlat(index)
    if refine == "RSQ8t":
        return IndexRefineSQ8Tier(index)
    return index


def index_factory(d: int, spec: str, metric: int = D.METRIC_L2, *,
                  device="cuda") -> Index:
    """Build an index on ``device`` from a faiss-style factory string:
    the transforms wrap the index and its refine, IDMap wraps it all."""
    prefixes, head, code, refine = _split(spec)
    chain, idmap = [], None
    for tok in prefixes:
        if tok in ("IDMap", "IDMap2"):
            idmap = IndexIDMap2 if tok == "IDMap2" else IndexIDMap
        else:
            chain.append(_transform(tok, d, device))
            d = chain[-1].d_out
    index = _refined(_container(d, head, code, metric, device), refine)
    if chain:
        index = IndexPreTransform(*chain, index)
    return idmap(index) if idmap else index


def _coarse(kind: str, M: int, nbits: int, d: int, nlist: int, metric: int,
            device) -> Index:
    """The parenthesized coarse quantizer RCQ<M>x<b> / LSCQ<M>x<b>, whose
    ksub^M centroids must number nlist (reference :66-82)."""
    if (1 << (M * nbits)) != nlist:
        raise ValueError(
            f"index_factory: {kind}{M}x{nbits} yields {1 << (M * nbits)} "
            f"centroids, but nlist={nlist}")
    cls = ResidualCoarseQuantizer if kind == "RCQ" else \
        LocalSearchCoarseQuantizer
    return cls(d, M, nbits, metric, device=device)


def _container(d: int, head: str, code, metric: int, device) -> Index:
    if m := re.fullmatch(_IVF, head):
        code = code or "Flat"
        nlist, hnsw_m = int(m.group(1)), int(m.group(2) or 0)
        coarse = m.group(3)
        if code == "Flat":
            if hnsw_m:
                return IndexIVFHNSW(d, nlist, metric, M=hnsw_m,
                                    device=device)
        if code == "FlatDedup":
            # over an IndexFlat quantizer whatever the prefix, as the
            # reference builds it
            return IndexIVFFlatDedup(IndexFlat(d, metric, device=device), d,
                                     nlist, metric, device=device)
        if hnsw_m:
            quant = IndexHNSWFlat(d, hnsw_m, metric, device=device)
        elif coarse:
            quant = _coarse(coarse, int(m.group(4)), int(m.group(5)), d,
                            nlist, metric, device)
        else:
            quant = IndexFlat(d, metric, device=device)
        index = _ivf_code(quant, d, nlist, code, metric, device)
        if coarse:
            # the virtual quantizer trains alone (reference :84-154)
            index.quantizer_trains_alone = 1
        return index
    if m := re.fullmatch(r"HNSW(\d+)?", head):
        # parse_IndexHNSW's storage codes (index_factory.cpp:443-490)
        hm = int(m.group(1) or 32)
        if code in (None, "Flat"):
            return IndexHNSWFlat(d, hm, metric, device=device)
        if mm := re.fullmatch(r"PQ(\d+)(?:x(\d+))?", code):
            return IndexHNSWPQ(d, int(mm.group(1)), hm,
                               int(mm.group(2) or 8), metric, device=device)
        if code in _HNSW_SQ:
            return IndexHNSWSQ(d, _HNSW_SQ[code], hm, metric, device=device)
        if mm := re.fullmatch(r"(\d+)\+PQ(\d+)", code):
            return IndexHNSW2Level(d, int(mm.group(1)), int(mm.group(2)), hm,
                                   metric=metric, device=device)
        raise _unknown_token(code)
    if m := re.fullmatch(r"NSG(\d+)?", head):
        # parse_IndexNSG's storage codes (index_factory.cpp:492-516)
        R = int(m.group(1) or 32)
        if code in (None, "Flat"):
            return IndexNSGFlat(d, R, metric, device=device)
        if mm := re.fullmatch(r"PQ(\d+)(?:x(\d+))?", code):
            return IndexNSGPQ(d, int(mm.group(1)), R, int(mm.group(2) or 8),
                              metric, device=device)
        if code in _SQ_TYPES:
            return IndexNSGSQ(d, _SQ_TYPES[code], R, metric, device=device)
        raise _unknown_token(code)
    if code is not None:
        raise _unknown_token(code)
    if m := re.fullmatch(_LSH, head):
        # index_factory.cpp:545; the codes are whole bytes
        nbits = -(-int(m.group(1) or d) // 8) * 8
        return IndexLSH(d, nbits, rotate_data=bool(m.group(2)),
                        train_thresholds=bool(m.group(3)), device=device)
    if head == "Flat":
        return IndexFlat(d, metric, device=device)
    if head in _SQ_TYPES:
        return IndexScalarQuantizer(d, _SQ_TYPES[head], metric,
                                    device=device)
    if m := re.fullmatch(_PQ, head):
        return IndexPQ(d, int(m.group(1)), int(m.group(2) or 8), metric,
                       device=device)
    if m := re.fullmatch(_AQ, head):
        cls = IndexResidualQuantizer if m.group(1) == "RQ" else \
            IndexLocalSearchQuantizer
        return cls(d, int(m.group(2)), int(m.group(3)), metric,
                   device=device)
    if m := re.fullmatch(_PAQ, head):
        cls = IndexProductResidualQuantizer if m.group(1) == "PRQ" else \
            IndexProductLocalSearchQuantizer
        return cls(d, int(m.group(2)), int(m.group(3)), int(m.group(4)),
                   metric, device=device)
    if m := re.fullmatch(_LATTICE, head):
        # index_factory.cpp:554 "ZnLattice<nsq>x<r2>_<scale_nbit>"
        return IndexLattice(d, int(m.group(1)), int(m.group(3)),
                            int(m.group(2)), metric, device=device)
    raise _unknown_token(head)


def _ivf_code(quant: Index, d: int, nlist: int, code: str, metric: int,
              device) -> IndexIVF:
    """The IVF index of code token ``code`` over ``quant``."""
    if code == "Flat":
        return IndexIVFFlat(quant, d, nlist, metric, device=device)
    if code in _SQ_TYPES:
        return IndexIVFScalarQuantizer(quant, d, nlist, _SQ_TYPES[code],
                                       metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)\+(\d+)", code):
        # IVFPQR: the base PQ and a refinement PQ, 8 bits each
        return IndexIVFPQR(quant, d, nlist, int(m.group(1)), 8,
                           int(m.group(2)), 8, metric, device=device)
    if m := re.fullmatch(_PQ, code):
        # "fs" is the 4-bit packed layout, "np" no polysemous training
        # (neither package trains it here)
        return IndexIVFPQ(quant, d, nlist, int(m.group(1)),
                          int(m.group(2) or 8), metric, device=device)
    if m := re.fullmatch(_AQ, code):
        cls = IndexIVFResidualQuantizer if m.group(1) == "RQ" else \
            IndexIVFLocalSearchQuantizer
        return cls(quant, d, nlist, int(m.group(2)), int(m.group(3)),
                   metric, device=device)
    if m := re.fullmatch(_PAQ, code):
        cls = IndexIVFProductResidualQuantizer if m.group(1) == "PRQ" \
            else IndexIVFProductLocalSearchQuantizer
        return cls(quant, d, nlist, int(m.group(2)), int(m.group(3)),
                   int(m.group(4)), metric, device=device)
    raise _unknown_token(code)


def get_code_size(d: int, spec: str) -> int:
    """Per-vector storage bytes implied by a factory string
    (contrib/factory_tools.py:get_code_size role): a refine suffix adds
    its rows (4 d bytes for RFlat, d for RSQ8t), IDMap its 8-byte ids,
    and a transform that changes d the code's width."""
    prefixes, head, code, refine = _split(spec)
    size = {None: 0, "RFlat": 4 * d, "RSQ8t": d}[refine]
    for tok in prefixes:
        if tok in ("IDMap", "IDMap2"):
            size += 8
        elif m := re.fullmatch(r"(?:PCA[RW]?|OPQ\d+_|RR)(\d+)", tok):
            d = int(m.group(1))
    if re.fullmatch(_IVF, head):
        return size + _code_bytes(d, code or "Flat")
    if m := re.fullmatch(r"HNSW(\d+)?", head):
        links = 4 * 2 * int(m.group(1) or 32)   # ~2M int32 level-0 edges
        return size + links + _code_bytes(d, code or "Flat")
    if m := re.fullmatch(r"NSG(\d+)?", head):
        links = 4 * int(m.group(1) or 32)       # R int32 edges
        return size + links + _code_bytes(d, code or "Flat")
    if code is not None:
        raise _unknown_token(code)
    return size + _code_bytes(d, head)


def _code_bytes(d: int, code: str) -> int:
    if code == "Flat":
        return 4 * d
    if code in _SQ_TYPES:
        return (d * _SQ_BITS[code] + 7) // 8
    if m := re.fullmatch(r"PQ(\d+)\+(\d+)", code):
        return int(m.group(1)) + int(m.group(2))
    if m := re.fullmatch(r"PQ(\d+)(?:x(\d+))?(?:fs(?:_\d+)?)?", code):
        return (int(m.group(1)) * int(m.group(2) or 8) + 7) // 8
    if m := re.fullmatch(_AQ, code):
        # a byte a stage and the f32 norm (ST_norm_float)
        return int(m.group(2)) + 4
    if m := re.fullmatch(_PAQ, code):
        return int(m.group(2)) * int(m.group(3)) + 4
    if m := re.fullmatch(_LSH, code):
        return -(-int(m.group(1) or d) // 8)
    raise _unknown_token(code)


def get_hnsw_M(index) -> int:
    """Max level-0 degree parameter of an HNSW index
    (factory_tools.get_hnsw_M)."""
    return int(index.hnsw.M)


def reverse_index_factory(index) -> str:
    """A factory string that re-parses to the same index class and layout
    (contrib/factory_tools.py:reverse_index_factory role)."""
    if isinstance(index, IndexIDMap):
        tok = "IDMap2" if isinstance(index, IndexIDMap2) else "IDMap"
        return f"{tok},{reverse_index_factory(index.index)}"
    if isinstance(index, IndexPreTransform):
        return ",".join([_transform_token(vt) for vt in index.chain]
                        + [reverse_index_factory(index.index)])
    if isinstance(index, IndexRefine):
        if isinstance(index.refine_index, IndexFlat):
            return reverse_index_factory(index.base_index) + ",RFlat"
        raise ValueError("cannot reverse non-Flat refine")
    if isinstance(index, IndexRefineSQ8Tier):
        return reverse_index_factory(index.base_index) + ",RSQ8t"
    if isinstance(index, IndexIVF):
        prefix = f"IVF{index.nlist}"
        q = index.quantizer
        if isinstance(q, IndexHNSW):
            prefix += f"_HNSW{get_hnsw_M(q)}"
        elif isinstance(q, AdditiveCoarseQuantizer):
            kind = "LSCQ" if isinstance(q, LocalSearchCoarseQuantizer) \
                else "RCQ"
            prefix += f"({kind}{q.M}x{q.nbits})"
        if isinstance(index, IndexIVFPQR):
            return f"{prefix},PQ{index.M}+{index.M_refine}"
        if isinstance(index, IndexIVFPQ):
            suffix = "fs" if index.nbits == 4 else ""
            return f"{prefix},PQ{index.M}x{index.nbits}{suffix}"
        if isinstance(index, IndexIVFScalarQuantizer):
            return f"{prefix},{_SQ_NAMES[index.qtype]}"
        if isinstance(index, IndexIVFResidualQuantizer):
            return f"{prefix},{_aq_token(index)}"
        if isinstance(index, IndexIVFFlatDedup):
            # the reference returns ",Flat", which re-parses to another
            # class
            return f"{prefix},FlatDedup"
        return f"{prefix},Flat"
    if isinstance(index, IndexHNSWPQ):
        return f"HNSW{get_hnsw_M(index)},PQ{index.pq_m}x{index.nbits}"
    if isinstance(index, IndexHNSWSQ):
        name = {v: k for k, v in _HNSW_SQ.items()}[index.storage_dtype]
        return f"HNSW{get_hnsw_M(index)},{name}"
    if isinstance(index, IndexHNSW2Level):
        # the reference returns "HNSW<M>", which re-parses to another class
        c = index.codec
        return f"HNSW{get_hnsw_M(index)},{c.nlist}+PQ{c.M}"
    if isinstance(index, IndexHNSW):
        return f"HNSW{get_hnsw_M(index)}"
    if isinstance(index, IndexPQ):
        return f"PQ{index.M}x{index.nbits}"
    if isinstance(index, IndexResidualQuantizer):
        return _aq_token(index)
    if isinstance(index, IndexLSH):
        return (f"LSH{index.nbits}" + ("r" if index.rotate_data else "")
                + ("t" if index.train_thresholds else ""))
    if isinstance(index, IndexNSGFlat):
        tok = f"NSG{index.R}"
        if isinstance(index, IndexNSGPQ):
            return f"{tok},PQ{index.pq_m}x{index.nbits}"
        if isinstance(index, IndexNSGSQ):
            return f"{tok},{_SQ_NAMES[index.qtype]}"
        return tok
    if isinstance(index, IndexLattice):
        # the reference cannot reverse IndexLattice
        return f"ZnLattice{index.nsq}x{index.zn.r2}_{index.scale_nbit}"
    if isinstance(index, IndexScalarQuantizer):
        return _SQ_NAMES[index.qtype]
    if isinstance(index, IndexFlat):
        return "Flat"
    raise ValueError(f"cannot reverse {type(index).__name__}")


def _aq_token(index) -> str:
    """RQ<M>x<b>, LSQ..., PRQ<n>x<M>x<b> or PLSQ... of an additive index,
    flat or IVF."""
    kind = "LSQ" if "LocalSearch" in type(index).__name__ else "RQ"
    if hasattr(index, "nsplits"):
        return f"P{kind}{index.nsplits}x{index.Msub}x{index.nbits}"
    return f"{kind}{index.M}x{index.nbits}"


def _transform_token(vt) -> str:
    if isinstance(vt, OPQMatrix):
        return f"OPQ{vt.M}_{vt.d_out}" if vt.d_out != vt.d_in \
            else f"OPQ{vt.M}"
    if isinstance(vt, PCAMatrix):
        kind = {(0.0, False): "", (0.0, True): "R", (-0.5, False): "W"}.get(
            (vt.eigen_power, vt.random_rotation))
        if kind is not None:
            return f"PCA{kind}{vt.d_out}"
    if isinstance(vt, RandomRotationMatrix):
        return f"RR{vt.d_out}"
    if isinstance(vt, NormalizationTransform) and vt.norm == 2.0:
        return "L2norm"
    raise ValueError(f"cannot reverse transform {type(vt).__name__}")


def index_binary_factory(d: int, spec: str, *, device="cuda"):
    """A binary index from its factory string (index_factory.cpp:907-944
    ``index_binary_factory``): BFlat, BIVF<n>, BIVF<n>_HNSW<M>, BHNSW<M>,
    BHash<b>, BHash<nhash>x<b>."""
    if m := re.fullmatch(r"BIVF(\d+)(?:_HNSW(\d+))?", spec):
        quant = IndexBinaryHNSW(d, int(m.group(2)), device=device) \
            if m.group(2) else IndexBinaryFlat(d, device=device)
        return IndexBinaryIVF(quant, d, int(m.group(1)), device=device)
    if m := re.fullmatch(r"BHNSW(\d+)", spec):
        return IndexBinaryHNSW(d, int(m.group(1)), device=device)
    if m := re.fullmatch(r"BHash(\d+)x(\d+)", spec):
        return IndexBinaryMultiHash(d, int(m.group(1)), int(m.group(2)),
                                    device=device)
    if m := re.fullmatch(r"BHash(\d+)", spec):
        return IndexBinaryHash(d, int(m.group(1)), device=device)
    if spec == "BFlat":
        return IndexBinaryFlat(d, device=device)
    raise ValueError(f"description {spec!r} did not generate a binary index")
