"""The instruction counter of ``bench/diag/sass_counts`` on a canned piece
of ``cuobjdump -sass`` output (the tool itself builds and disassembles
only where the CUDA toolkit is installed)."""

from oryx_tpu_torch.bench.diag.sass_counts import EPILOGUE_OPS, opcode_counts

SASS = """
        code for sm_90a
                Function : _ZN2qm10phase_a_qmILi4ELi64ELb1EEEvPf
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FADD R0, R24, R2 ;
        /*0020*/                   LOP3.LUT R3, R4, R5, RZ, 0x3c, !PT ;
        /*0030*/                   POPC R3, R3 ;
        /*0040*/                   ISETP.GT.AND P0, PT, R3, UR4, PT ;
        /*0050*/              @!P0 FMNMX R6, R6, R0, !PT ;
        /*0060*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0070*/                   EXIT ;
                ..........
                Function : _ZN5other6kernelEv
        /*0000*/                   FADD R0, R1, R2 ;
"""


def test_counts_only_the_named_kernels_functions():
    counts = opcode_counts(SASS, "phase_a_qm")
    assert list(counts) == ["_ZN2qm10phase_a_qmILi4ELi64ELb1EEEvPf"]
    (c,) = counts.values()
    assert sum(c.values()) == 8
    assert {op: c[op] for op in EPILOGUE_OPS} == {
        "FADD": 1, "LOP3": 1, "POPC": 1, "ISETP": 1, "FSEL": 0, "FMNMX": 1}
    assert c["HGMMA"] == 1 and c["EXIT"] == 1


def test_every_function_without_a_filter():
    assert len(opcode_counts(SASS)) == 2
