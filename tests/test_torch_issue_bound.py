"""The issue bound of chip_smoke.py, on the CPU.

chip_smoke.py (phase 1) counts what one iteration of each march kernel's
loop issues, by pipe, from nvdisasm of the kernel built for the card
(``loop_issue``), and ``march_bound`` turns those counts, the steps of a
march and the card's SMs and clock into the least time of the march. Both
are plain Python: here they run on a small listing written in nvdisasm's
format whose straight path is known by hand, and on a made-up card.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

# as nvcc names march_kernel<float, METHOD_RK4, DEST_THETA> (an anonymous namespace)
KERNEL = ("_ZN40_GLOBAL__N__366e562c_8_march_cu_0a23ae1c12march_kernelIfLi1ELi0EEEv"
          "N2rt6ParamsIT_EENS1_6FieldsIS3_EElPy")

# One loop (.L_x_0 to the latch at 0x01a0). Its straight paths: the header,
# the fast branch past the out-of-line trig (a CALL to a *_far function is
# a slow path), the fast side of an inner loop (.L_x_5: a Payne-Hanek-like
# loop, slow), then either the early return to .L_x_3 (no square root: not
# a full iteration) or the full step with its square root, the pow
# subroutine (a special-case RET or its whole body) and an optional clamp
# (a divide, skipped to .L_x_4).
LISTING = f"""
.text.{KERNEL}:
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0020*/                   FADD R2, R2, R3 ;
        /*0030*/                   FSETP.GE.AND P0, PT, |R2|, 105615, PT ;
        /*0040*/               @P0 BRA `(.L_x_1) ;
        /*0050*/                   FFMA R4, R2, R3, R4 ;
        /*0060*/                   F2I.NTZ R5, R4 ;
        /*0070*/                   BRA `(.L_x_2) ;
.L_x_1:
        /*0080*/                   MOV R20, 0xa0 ;
        /*0090*/                   CALL.REL.NOINC `($x$_ZN2rt10sincos_farEf) ;
.L_x_2:
        /*00a0*/                   MUFU.RCP R6, R4 ;
        /*00b0*/                   DADD R8, R8, R10 ;
        /*00c0*/                   ISETP.NE.AND P3, PT, R7, RZ, PT ;
        /*00d0*/               @P3 BRA `(.L_x_5) ;
        /*00e0*/                   ISETP.NE.AND P1, PT, R7, 0x1, PT ;
        /*00f0*/               @P1 BRA `(.L_x_3) ;
        /*0100*/                   MUFU.RSQ R9, R9 ;
        /*0110*/                   MOV R21, 0x130 ;
        /*0120*/                   CALL.REL.NOINC `($__internal_0_$__internal_accurate_pow) ;
        /*0130*/                   FSETP.GT.AND P5, PT, R9, R12, PT ;
        /*0140*/               @P5 BRA `(.L_x_4) ;
        /*0150*/                   MUFU.RCP R9, R9 ;
        /*0160*/                   FMUL R9, R9, R9 ;
.L_x_4:
        /*0170*/                   FMUL R9, R9, R9 ;
.L_x_3:
        /*0180*/                   IADD3 R7, R7, 0x1, RZ ;
        /*0190*/                   ISETP.LT.AND P2, PT, R7, R12, PT ;
        /*01a0*/               @P2 BRA `(.L_x_0) ;
        /*01b0*/                   EXIT ;
.L_x_5:
        /*01c0*/                   LOP3.LUT R13, R13, 0x1, RZ, 0xc0, !PT ;
        /*01d0*/                   ISETP.NE.AND P4, PT, R13, RZ, PT ;
        /*01e0*/               @P4 BRA `(.L_x_5) ;
        /*01f0*/                   BRA `(.L_x_3) ;
.L_x_6:
        /*0200*/                   BRA `(.L_x_6) ;
$x$_ZN2rt10sincos_farEf:
        /*0210*/                   STL [R1], R2 ;
        /*0220*/                   RET.REL.NODEC R20 `({KERNEL}) ;
$__internal_0_$__internal_accurate_pow:
        /*0230*/                   DSETP.NEU.AND P6, PT, R2, 1, PT ;
        /*0240*/              @!P6 RET.REL.NODEC R21 `({KERNEL}) ;
        /*0250*/                   DFMA R2, R2, R4, R6 ;
        /*0260*/                   DMUL R2, R2, R2 ;
        /*0270*/                   RET.REL.NODEC R21 `({KERNEL}) ;
.nv.constant0.{KERNEL}:
"""


def test_loop_issue_counts_the_straight_path_of_the_march_loop():
    kernels = chip_smoke.sass_kernels(LISTING)
    assert list(kernels) == [KERNEL]
    instrs, labels = kernels[KERNEL]
    assert len(instrs) == 40 and labels["$__internal_0_$__internal_accurate_pow"] == 35
    c = chip_smoke.loop_issue(instrs, labels)
    assert chip_smoke.issue_by_kernel(LISTING) == {("rk4", "theta", "float32"): c}
    # least: header 3, fast trig 3, 0x00a0-0x00d0 4, 0x00e0-0x00f0 2, the
    # square root's block 3 + pow's special case 2, 0x0130-0x0140 2, past
    # the clamp 1, latch 3 (the early return, 15, takes no square root)
    assert {p: c["least"][p] for p in chip_smoke.PIPES} == dict(
        fp32=3, fp64=2, mufu=2, int=7, conv=1, total=23)
    assert c["least"]["other"] == 8
    # most: the clamp's 2 and pow's whole body, 3 more
    assert {p: c["most"][p] for p in chip_smoke.PIPES} == dict(
        fp32=4, fp64=4, mufu=3, int=7, conv=1, total=28)
    assert c["most"]["other"] == 9


def test_loop_issue_least_is_taken_pipe_by_pipe():
    """Two full paths, one lighter in FP32 and one in FP64: each pipe's
    least comes from the path that issues the fewer of it."""
    listing = f"""
.text.{KERNEL}:
.L_x_0:
        /*0000*/                   MUFU.RSQ R1, R1 ;
        /*0010*/                   MUFU.RCP R2, R2 ;
        /*0020*/               @P0 BRA `(.L_x_1) ;
        /*0030*/                   FADD R3, R3, R3 ;
        /*0040*/                   FADD R3, R3, R3 ;
        /*0050*/                   DADD R4, R4, R4 ;
        /*0060*/                   BRA `(.L_x_2) ;
.L_x_1:
        /*0070*/                   FADD R3, R3, R3 ;
        /*0080*/                   DADD R4, R4, R4 ;
        /*0090*/                   DADD R4, R4, R4 ;
        /*00a0*/                   DADD R4, R4, R4 ;
.L_x_2:
        /*00b0*/               @P1 BRA `(.L_x_0) ;
        /*00c0*/                   EXIT ;
.nv.constant0.{KERNEL}:
"""
    c = chip_smoke.issue_by_kernel(listing)["rk4", "theta", "float32"]
    assert (c["least"]["fp32"], c["least"]["fp64"], c["least"]["total"]) == (1, 1, 8)
    assert (c["most"]["fp32"], c["most"]["fp64"], c["most"]["total"]) == (1, 3, 8)


def test_march_bound_takes_the_binding_pipe():
    """Per-pipe, issue and byte times of a march on a made-up card of
    2 SMs at 1 GHz, with the steps of the rays that ended unstuck."""
    class Out:
        steps = torch.tensor([1000, 3000, -7, 0], dtype=torch.int32)
        n_rays = 4

    chip_smoke.CARD.update(sms=2, clock_hz=1e9)
    least = dict(fp32=400, fp64=0, mufu=20, int=200, conv=8, total=800)
    chip_smoke.STEP_ISSUE["rk4", "theta", "float32"] = dict(least=least, most=dict(least, total=900))
    least = dict(fp32=0, fp64=1000, mufu=30, int=400, conv=12, total=1900)
    chip_smoke.STEP_ISSUE["rk45", "isco", "float64"] = dict(least=least, most=dict(least, fp64=1100))
    try:
        ms, pipe = chip_smoke.march_bound(Out, "rk4", "theta", torch.float32)
        # issue: 800 x 4000 steps / (128 x 2 x 1e9) = 12.5 us; int 200 x 4000 / (64 x 2e9) 6.25 us
        assert pipe == "issue" and ms == pytest.approx(800 * 4000 / (128 * 2e9) * 1e3)
        ms, pipe = chip_smoke.march_bound(Out, "rk45", "isco", torch.float64)
        # fp64: 1000 x 4000 / (64 x 2e9) = 31.25 us against issue 29.7 us
        assert pipe == "fp64" and ms == pytest.approx(1000 * 4000 / (64 * 2e9) * 1e3)
        Out.steps = torch.tensor([0, -3, 0, 0], dtype=torch.int32)  # every ray stuck or dead
        ms, pipe = chip_smoke.march_bound(Out, "rk45", "isco", torch.float64)
        assert pipe == "bytes" and ms == pytest.approx(4 * (15 * 8 + 18 + 11 * 8 + 18) / 3.35e12 * 1e3)
    finally:
        chip_smoke.CARD.clear()
        chip_smoke.STEP_ISSUE.clear()
