"""chip_smoke.parse_sass_mma on short canned `cuobjdump -sass` listings: it
counts warp-level mma.sync (HMMA) and warpgroup wgmma (HGMMA) per kernel,
and tells the two apart. Runs on the CPU: no card, no cuobjdump."""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LISTING = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

        code for sm_90a
                Function : _ZN12_GLOBAL__N_121flat_knn_fused_kernelE14CUtensorMap_stS0_PKfiiiiPfPi
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a50*/                   WARPGROUP.ARRIVE ;
        /*0a60*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0a70*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0a80*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
        /*0a90*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*0aa0*/                   EXIT ;
                ..........

                Function : _ZN12_GLOBAL__N_120ivf_scan_fused_kernelEv
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDSM.16.M88.4 R8, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
        /*0030*/                   EXIT ;
                ..........

                Function : _Z11copy_kernelv
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0010*/                   EXIT ;
"""

K1 = "_ZN12_GLOBAL__N_121flat_knn_fused_kernelE14CUtensorMap_stS0_PKfiiiiPfPi"


@pytest.mark.parametrize("fn,hmma,hgmma", [
    (K1, 0, 3),
    ("_ZN12_GLOBAL__N_120ivf_scan_fused_kernelEv", 2, 0),
    ("_Z11copy_kernelv", 0, 0),
])
def test_parse_sass_mma_counts_each_kernel(fn, hmma, hgmma):
    found = _chip_smoke().parse_sass_mma(LISTING)
    assert found[fn] == {"HMMA": hmma, "HGMMA": hgmma}


def test_parse_sass_mma_lists_every_function_and_nothing_else():
    found = _chip_smoke().parse_sass_mma(LISTING)
    assert len(found) == 3
    assert _chip_smoke().parse_sass_mma("") == {}


def test_parse_sass_mma_ignores_lines_before_the_first_function():
    found = _chip_smoke().parse_sass_mma(
        "        /*0000*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n" + LISTING)
    assert sum(v["HMMA"] for v in found.values()) == 2
