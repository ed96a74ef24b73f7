"""The kernel build's report helpers on the CPU: nvcc's ptxas report parsed
per kernel (registers and spill bytes, as chip_smoke.py prints them beside
the slot bodies' times), the ctypes signatures against the C entry points of
csrc/*.cu, and ab_slots.py's CTAs-per-SM count for trees without an
occupancy query, its choice of a kernel's report entry between two trees'
names, its output digests and its count of a SASS loop's instructions."""

import os
import re
import sys

import pytest
import torch

from mini_nbody_tpu_torch import _build

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import ab_slots  # noqa: E402

K3 = ("_ZN12_GLOBAL__N_122symmetric_force_kernelILi128ELi3ELb1EEEvPKiiPKfS4_"
      "Pfxf")
K2 = ("_ZN12_GLOBAL__N_116slot_pipe_kernelILi128ELb0EEEvPKiiPKfS4_S4_S4_"
      "Pfxfii")
LOG = f"""== symmetric_force.cu
ptxas info    : Compiling entry function '{K3}' for 'sm_90a'
ptxas info    : Function properties for {K3}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
== slot_pipe.cu
ptxas info    : Compiling entry function '{K2}' for 'sm_90a'
ptxas info    : Function properties for {K2}
    16 bytes stack frame, 32 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 119 registers, used 1 barriers, 420 bytes cmem[0]
"""


def test_ptxas_report_per_kernel():
    report = _build.ptxas_report(LOG)
    assert report == {
        K3: {"registers": 128, "spill_stores": 0, "spill_loads": 0},
        K2: {"registers": 119, "spill_stores": 32, "spill_loads": 24}}
    assert _build.ptxas_report("") == {}


@pytest.mark.parametrize("regs,threads,smem,ctas", [
    (36, 256, 70144, 3),    # K3's shared W tile body: shared memory binds
    (32, 256, 76800, 3),    # K2's shared W tile body
    (128, 256, 17920, 2),   # K3's register body: registers bind
    (168, 128, 28928, 3),   # K2's register body (two strips a warp)
    (80, 256, 45312, 3),
    (32, 64, 1024, 32),     # the CTA limit
    (78, 256, 89088, 2),    # B14's shared W and C tiles at tile 128
    (40, 512, 16384, 3),    # B10 one thread per receiver at block 512
])
def test_ctas_per_sm(regs, threads, smem, ctas):
    assert ab_slots.ctas_per_sm(regs, threads, smem) == ctas


B16_OLD = ("_ZN12_GLOBAL__N_115band_mxu_kernelILi128ELb0EEEvPKfS2_S2_S2_PfS3_"
           "iiixfii")


def _entry(name, regs):
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Used {regs} registers\n")


#: A tree of this redesign: B16 without fast rsqrt (168 registers) listed
#: before B16 with it (158); the parent: its one B16 (32).
NEW_LOG = (_entry(B16_OLD.replace("ELb0EE", "ELb0ELb0EE"), 168)
           + _entry(B16_OLD.replace("ELb0EE", "ELb0ELb1EE"), 158))
OLD_LOG = _entry(B16_OLD, 32)


B10_OLD = ("_ZN12_GLOBAL__N_118vjp_ordered_kernelILb1ELi0EEEvPKfS2_S2_iS2_S2_"
           "S2_iPffi")
B10_NEW = ("_ZN12_GLOBAL__N_118vjp_ordered_kernelILi4ELb1EEEvPKfS2_S2_iS2_S2_"
           "S2_iPffi")
B14 = ("_ZN12_GLOBAL__N_119vjp_rect_mxu_kernelILi128ELi4EEEvPKfS2_iS2_S2_"
       "iPffi")


@pytest.mark.parametrize("log,names,regs", [
    (_entry(B10_OLD, 40), ab_slots.SLOT_KERNELS["B10"], 40),
    (_entry(B10_NEW.replace("Li4E", "Li2E"), 93) + _entry(B10_NEW, 128),
     ab_slots.SLOT_KERNELS["B10"], 128),
    (_entry(B14.replace("Li4EE", "Li3EE"), 80) + _entry(B14, 78),
     ab_slots.SLOT_KERNELS["B14"], 78),
    (NEW_LOG, ab_slots.SLOT_KERNELS["B16"], 158),
    (OLD_LOG, ab_slots.SLOT_KERNELS["B16"], 32),
    # The parent's name alone matches this tree's first B16, the wrong one.
    (NEW_LOG, ab_slots.SLOT_KERNELS["B16"][1:], 168),
    (LOG, ab_slots.SLOT_KERNELS["K2"], 119),
    (LOG, ("no_such_kernel",), None),
])
def test_find_kernel_prefers_this_trees_name(log, names, regs):
    got = ab_slots.find_kernel(_build.ptxas_report(log), names)
    assert got.get("registers") == regs


def test_digest_is_of_the_bits():
    a = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
    assert ab_slots.digest(a) == ab_slots.digest(a.clone())
    assert ab_slots.digest(a.T) == ab_slots.digest(a.T.contiguous())
    assert ab_slots.digest(a) != ab_slots.digest(-a)  # 0.0 and -0.0 differ
    assert ab_slots.digest(a, a) != ab_slots.digest(a)
    assert len(ab_slots.digest(a)) == 16


#: A SASS listing in cuobjdump's form: a loop of 6 instructions with 2
#: rsqrts (a backward branch to its label), inside it a predicated branch
#: forward, then a loop by address with 1 rsqrt, and a loop with none.
SASS = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   FADD R2, R3, R4 ;
        /*0020*/                   MUFU.RSQ R5, R2 ;
        /*0030*/               @P0 BRA `(.L_x_2) ;
        /*0040*/                   MUFU.RSQ R6, R2 ;
.L_x_2:
        /*0050*/                   FFMA R7, R5, R6, R7 ;
        /*0060*/               @P1 BRA `(.L_x_1) ;
        /*0070*/                   MUFU.RSQ R8, R7 ;
        /*0080*/                   BRA 0x70 ;
        /*0090*/                   IADD3 R9, R9, 0x1, RZ ;
        /*00a0*/               @P2 BRA `(.L_x_3) ;
.L_x_3:
        /*00b0*/                   BRA 0x90 ;
        /*00c0*/                   EXIT ;
"""


def test_sass_loops_count_each_rsqrt_loop():
    assert ab_slots.sass_loops(SASS) == [(6, 2), (2, 1)]
    assert ab_slots.sass_loops("") == []


RESCALED_SASS = """
.L_x_4:
        /*0000*/                   FSETP.GEU.AND P0, PT, |R2|, 1.175494350822287508e-38, PT ;
        /*0010*/               @!P0 FMUL R2, R2, 16777216 ;
        /*0020*/                   MUFU.RSQ R3, R2 ;
        /*0030*/               @!P0 FMUL R3, R3, 4096 ;
        /*0040*/               @P1 BRA `(.L_x_4) ;
.L_x_5:
        /*0050*/                   MUFU.RSQ R4, R5 ;
        /*0060*/               @P2 BRA `(.L_x_5) ;
"""


def test_sass_rescales_count_rsqrtf_denormal_scaling():
    # rsqrtf's rescaling multiplies a denormal input by 2^24; the
    # rsqrt.approx.ftz loop has none.
    assert ab_slots.sass_loops(RESCALED_SASS) == [(5, 1), (2, 1)]
    assert ab_slots.sass_rescales(RESCALED_SASS) == [1, 0]
    assert ab_slots.sass_rescales(SASS) == [0, 0]


def test_signatures_match_the_c_entry_points():
    # Every C entry of csrc/*.cu has a ctypes signature with its number of
    # arguments, and every signature names an entry.
    entries = {}
    for src in _build.CSRC.glob("*.cu"):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern "C"[^(]*?(\w+)\(([^)]*)\)', text):
            entries[m.group(1)] = len(m.group(2).split(","))
    assert set(entries) == set(_build.SIGNATURES)
    for name, (argtypes, _) in _build.SIGNATURES.items():
        assert len(argtypes) == entries[name], name
