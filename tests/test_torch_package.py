"""The PyTorch port (tpu_ann_torch) stands alone: importing it, its
distribution layer tpu_ann_torch.parallel, its C handle's Python side
tpu_ann_torch.capi and its entry points tpu_ann_torch.graft_entry loads
neither jax, the JAX package nor ml_dtypes (the GPU machine has none of
them), and no source file of it (Python, CUDA or C) refers to them: the C
handle imports tpu_ann_torch.capi, never the JAX package's capi."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_ann_torch")


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import tpu_ann_torch\n"
        "import tpu_ann_torch.parallel\n"
        "import tpu_ann_torch.capi\n"
        "import tpu_ann_torch.graft_entry\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', "
        "'tpu_ann', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    out = []
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith((".py", ".cu", ".cuh", ".c", ".h"))]
    return sorted(out)


def test_sources_found():
    names = {os.path.relpath(p, PKG) for p in _sources()}
    assert {"__init__.py", "ops/ivf_scan_fused.py",
            "csrc/ivf_scan_fused.cu", "kernels/__init__.py",
            "ops/flat_knn_fused.py", "csrc/flat_knn_fused.cu",
            "csrc/reservoir_topk.cu", "models/selectors.py",
            "ops/ivf_scan_paged.py", "csrc/ivf_scan_paged.cu",
            "csrc/ivf_scan_core.cuh", "models/ivf_paged.py",
            "ops/topk.py", "ops/sq.py", "csrc/ivf_scan_sq8.cu",
            "models/pq.py", "models/ivf_pq.py", "utils/convert.py",
            "utils/index_io.py", "utils/invlists_io.py", "utils/factory.py",
            "utils/benchmark.py", "models/ivf_hnsw.py", "models/base.py",
            "models/ivf.py", "ops/range_search.py", "utils/contrib.py",
            "ops/ivf_scan.py", "parallel/__init__.py", "parallel/sharded.py",
            "utils/interrupt.py", "utils/memory.py", "utils/native.py",
            "utils/rpc.py", "utils/client_server.py",
            "utils/offline_pipeline.py", "utils/bench_fw.py",
            "utils/analyzers.py", "utils/datasets.py",
            "utils/evaluation.py", "capi.py", "c_api/tpu_ann_c.c",
            "c_api/tpu_ann_c.h", "c_api/example_c.c", "graft_entry.py",
            "demos/__init__.py"} | {
            f"demos/demo_{n}.py" for n in (
                "custom_invlists", "ondisk_ivf", "paged_outofcore",
                "auto_tune", "client_server_ivf", "sharded_search",
                "residual_quantizer", "qinco")} <= names


def test_c_handle_imports_the_port():
    with open(os.path.join(PKG, "c_api", "tpu_ann_c.c")) as f:
        src = f.read()
    assert 'PyImport_ImportModule("tpu_ann_torch.capi")' in src
    assert src.count("PyImport_ImportModule(") == 1


@pytest.mark.parametrize("needle", ["import jax", "tpu_ann.", "ml_dtypes"])
def test_no_reference_imports(needle):
    hits = []
    for path in _sources():
        with open(path) as f:
            if needle in f.read():
                hits.append(os.path.relpath(path, ROOT))
    assert not hits, hits


def test_default_device_is_cuda_without_fallback(tmp_path):
    """Indexes default to the GPU; without one they fail instead of
    quietly running on the CPU."""
    import numpy as np
    import torch

    import tpu_ann_torch as T

    path = str(tmp_path / "paged")
    if torch.cuda.is_available():
        assert T.IndexFlat(8).device.type == "cuda"
        assert T.make_ivf_flat(8, 4).device.type == "cuda"
        assert T.IndexIVFFlatPaged(8, 4, path).device.type == "cuda"
        assert T.IndexScalarQuantizer(8).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            T.IndexFlat(8)
        with pytest.raises((AssertionError, RuntimeError)):
            T.make_ivf_flat(8, 4)
        with pytest.raises((AssertionError, RuntimeError)):
            T.IndexIVFFlatPaged(8, 4, path)
        sq = T.IndexScalarQuantizer(8, T.QT_8BIT_DIRECT)
        assert sq.device.type == "cuda"
        with pytest.raises((AssertionError, RuntimeError)):
            sq.add(np.zeros((2, 8), np.float32))
    assert T.IndexFlat(8, device="cpu").device.type == "cpu"
    assert T.IndexIVFFlatPaged(8, 4, path, device="cpu").device.type == "cpu"


def test_public_names_of_the_reference():
    """Every public name of tpu_ann (read from its __init__.py with ast,
    so no JAX loads) is a name of tpu_ann_torch."""
    import ast

    import tpu_ann_torch

    with open(os.path.join(ROOT, "tpu_ann", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets
                      if isinstance(t, ast.Name)}
    public = {n for n in names if not n.startswith("_") or n == "__version__"}
    missing = {n for n in public if not hasattr(tpu_ann_torch, n)}
    assert missing == set()
