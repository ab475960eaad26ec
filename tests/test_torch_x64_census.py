"""CPU tests of the SASS census of the x64 fill kernel K6 (in
kernel_variants.py) and of x64_ablation.py's variants: the census' pipe
classes and main-loop span on a canned ``cuobjdump -sass`` excerpt, the
bounds it gives, and every variant's substitutions against the kernel
source as it stands (the script itself runs only on the card)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import kernel_variants as kv  # noqa: E402
import x64_ablation as xa  # noqa: E402

# a Philox4x64 Gaussian instantiation: a prologue, a main loop with a
# nested slow-path loop, an epilogue after the back edge
SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_119fill_block64_kernelILi1ELb1EEEvPdllimNS_6Seed64Ei
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_CTAID.X ;                    /* 0x0000000000007919 */
        /*0020*/              @P0 EXIT ;                                   /* 0x000000000000094d */
.L_x_1:
        /*0030*/                   IMAD.WIDE.U32 R4, R2, -0x4b8c3b6d, RZ ; /* 0x0000000000007919 */
        /*0040*/                   IADD3 R6, P0, R4, R8, RZ ;              /* 0x0000000000007919 */
        /*0050*/                   LOP3.LUT R7, R5, R9, R10, 0x96, !PT ;   /* 0x0000000000007919 */
        /*0060*/                   DFMA R10, R12, R14, R16 ;               /* 0x0000000000007919 */
        /*0070*/              @!P1 BRA `(.L_x_2) ;                         /* 0x0000000000007919 */
.L_x_3:
        /*0080*/                   LDL R2, [R1] ;                          /* 0x0000000000007919 */
        /*0090*/              @P2 BRA `(.L_x_3) ;                          /* 0x0000000000007919 */
.L_x_2:
        /*00a0*/                   I2F.F64.U64 R20, R22 ;                  /* 0x0000000000007919 */
        /*00b0*/                   STG.E.128 desc[UR4][R2.64], R20 ;       /* 0x0000000000007919 */
        /*00c0*/                   UIADD3 UR4, UR4, 0x1, URZ ;             /* 0x0000000000007919 */
        /*00d0*/                   MUFU.RSQ64H R24, R25 ;                  /* 0x0000000000007919 */
        /*00e0*/              @P0 BRA `(.L_x_1) ;                          /* 0x0000000000007919 */
        /*00f0*/                   EXIT ;                                  /* 0x0000000000007919 */
.L_x_4:
        /*0100*/                   BRA `(.L_x_4);                          /* 0x0000000000007919 */
        /*0110*/                   NOP;                                    /* 0x0000000000007919 */
		..........
"""


def test_pipe_classes():
    assert kv.pipe_class("IMAD.WIDE.U32") == "imad"
    assert kv.pipe_class("IMAD.MOV.U32") == "move"
    assert kv.pipe_class("MOV") == "move"
    assert kv.pipe_class("LOP3.LUT") == "alu"
    assert kv.pipe_class("SHF.L.W.U32.HI") == "alu"
    assert kv.pipe_class("DFMA.RM") == "fp64"
    assert kv.pipe_class("MUFU.RCP64H") == "mufu"
    assert kv.pipe_class("I2F.F64.S64") == "conv"
    assert kv.pipe_class("STG.E.128") == "mem"
    assert kv.pipe_class("BSSY") == "branch"
    assert kv.pipe_class("BSYNC") == "branch"
    assert kv.pipe_class("UMOV") == "uniform"
    assert kv.pipe_class("ULDC.64") == "mem"
    assert kv.pipe_class("S2R") == "other"


def test_census_counts_the_main_loop():
    got = kv.k6_census(SASS, kv.k6_values_per_iter(""))
    c = got[("fill_block64_kernel", "philox4x64", True)]
    # 0x30..0xe0, less the nested loop 0x80..0x90: 10 instructions
    assert c["loop"] and c["instructions"] == 10 and c["static"] == 18
    # a source that names no X64_ROWS: two rows of a 4-word block an iteration
    assert c["values_per_iteration"] == 8
    assert c["per_value"] == {k: v / 8 for k, v in {
        "alu": 2, "branch": 2, "conv": 1, "fp64": 1, "imad": 1, "mem": 1,
        "mufu": 1, "uniform": 1}.items()}
    assert c["issue_per_value"] == 10 / 8


def test_operations_bound():
    per_value = {"fp64": 2.0, "imad": 1.0, "conv": 0.5, "move": 9.0,
                 "uniform": 9.0, "other": 1.5}
    values, hz = 132 * 64 * 1000, 1e9
    ms = kv.operations_ms(per_value, values, hz)
    # 2 FP64 operations a value at 64 a clock on 132 SMs at 1 GHz: 2 us
    assert ms["fp64"] == pytest.approx(2e-3)
    assert ms["imad"] == pytest.approx(1e-3)
    assert ms["conv"] == pytest.approx(0.5 * 4e-3)
    assert set(ms) == {"fp64", "imad", "alu", "fp32", "mufu", "conv"}
    # the busiest pipe bounds; moves and the uniform datapath do not, nor
    # the issue of every instruction, which is only reported
    assert kv.operations_bound(per_value, values, hz) == (
        pytest.approx(2e-3), "fp64")
    assert kv.issue_ms(per_value, values, hz) == pytest.approx(
        23.0 / 2 * 1e-3)


def test_values_per_iteration_follow_the_source():
    text = (REPO / "randblas_tpu_torch" / "csrc" / "x64_fill.cu").read_text()
    per = kv.k6_values_per_iter(text)
    assert per("fill_block64_kernel", 4) == 2 * 4
    assert per("fill_block64_T_kernel", 2) == 2 * 2 * 2


def test_every_variant_applies_to_the_source():
    text = (REPO / "randblas_tpu_torch" / "csrc" / "x64_fill.cu").read_text()
    variants = xa.VARIANTS
    assert {"full", "generation_only", "no_transform", "no_generator",
            "sin_and_cos"} <= set(variants)
    for name, subs in variants.items():
        for old, new in subs:
            assert old in text, (name, old)
        if xa.exact(name):
            assert subs, name
