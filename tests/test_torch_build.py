"""The kernel build's report helpers on the CPU: nvcc's ptxas report parsed
per kernel (registers and spill bytes, as chip_smoke.py prints them beside
the slot bodies' times), and ab_slots.py's CTAs-per-SM count for trees
without an occupancy query, its choice of a kernel's report entry between
two trees' names, and its output digests."""

import os
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


@pytest.mark.parametrize("log,names,regs", [
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
