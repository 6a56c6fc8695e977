"""latticeboltzmann_tpu_torch/utils/sass.py on listings in cuobjdump's
format: the parse, and the per-site path that chip_smoke.py counts the ds
kernel's instructions along (its bound and issue floor). The listings are
written here; the built kernels are read on the card."""

import collections

import pytest

from latticeboltzmann_tpu_torch.utils import sass

# a kernel shaped like the ds kernel: an early exit past the lattice's end,
# a forcing block that only some sites enter (taken by a guard and by a
# predicate operand), an IEEE division whose slow path is a called
# subroutine, the stores, the exit, the padding loop, the subroutine
_LISTING = """
\t\tFunction : _Z6kernelPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                     /* 0x00000a0000017a02 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;        /* 0x0000001000007c0c */
        /*0020*/               @P0 EXIT ;                                     /* 0x000000000000094d */
        /*0030*/                   FADD R2, R3, R4 ;                          /* 0x0000000403027221 */
        /*0040*/                   BSSY B0, 0x00a0 ;                          /* 0x0000005000007945 */
        /*0050*/               @P1 BRA 0x0090 ;                               /* 0x0000000000101947 */
        /*0060*/                   FADD R2, R2, R4 ;                          /* 0x0000000402027221 */
        /*0070*/               @P0 BRA P2, 0x0090 ;                           /* 0x0000000000040947 */
        /*0080*/                   FFMA R2, R2, R4, R5 ;                      /* 0x0000000402027223 */
        /*0090*/                   BSYNC B0 ;                                 /* 0x0000000000007941 */
        /*00a0*/                   MUFU.RCP R6, R2 ;                          /* 0x0000000200067308 */
        /*00b0*/              @!P0 BRA 0x00d0 ;                               /* 0x0000000000048947 */
        /*00c0*/                   CALL.REL.NOINC 0x0110 ;                    /* 0x0000000000107944 */
        /*00d0*/                   FMUL R7, R6, R2 ;                          /* 0x0000000206077220 */
        /*00e0*/                   STG.E [R8.64], R7 ;                        /* 0x0000000708007986 */
        /*00f0*/                   EXIT ;                                     /* 0x000000000000794d */
        /*0100*/                   BRA 0x0100;                                /* 0xfffffffc00fc7947 */
        /*0110*/                   FADD R9, R9, R9 ;                          /* 0x0000000909097221 */
        /*0120*/                   FFMA R9, R9, R9, R9 ;                      /* 0x0000000909097223 */
        /*0130*/                   RET.REL.NODEC R10 0x0 ;                    /* 0xffffff8c0a007950 */
\t\t..........


\t\tFunction : _Z5otherv
        /*0000*/              @PT FADD R2, R3, R4 ;                           /* 0x0000000403027221 */
        /*0010*/                   BRA 0x0030 ;                               /* 0x0000000000047947 */
        /*0020*/                   FMUL R2, R2, R2 ;                          /* 0x0000000202027220 */
        /*0030*/                   EXIT ;                                     /* 0x000000000000794d */
"""


def test_functions_splits_kernels_and_reads_guards():
    fns = sass.functions(_LISTING)
    assert list(fns) == ["_Z6kernelPf", "_Z5otherv"]
    kernel = fns["_Z6kernelPf"]
    assert len(kernel) == 20
    assert kernel[2] == (0x20, True, "EXIT", "")
    assert kernel[7] == (0x70, True, "BRA", "P2, 0x0090")
    assert kernel[10][2] == "MUFU.RCP"
    # a PT guard always holds
    assert fns["_Z5otherv"][0][1] is False


def test_site_path_skips_the_branches_some_sites_take():
    """The ordinary site's path: past the early exit, around the forcing
    block, through the division's fast path, to the stores and the exit;
    the called slow path is not on it."""
    path = sass.site_path(sass.functions(_LISTING)["_Z6kernelPf"])
    assert path == collections.Counter({
        "MOV": 1, "ISETP": 1, "EXIT": 2, "FADD": 1, "BSSY": 1, "BRA": 2, "BSYNC": 1,
        "MUFU": 1, "FMUL": 1, "STG": 1})


def test_site_path_follows_an_unconditional_branch():
    path = sass.site_path(sass.functions(_LISTING)["_Z5otherv"])
    assert path == collections.Counter({"FADD": 1, "BRA": 1, "EXIT": 1})


def test_site_path_needs_an_exit():
    instrs = sass.functions(_LISTING)["_Z6kernelPf"]
    no_exit = [i for i in instrs if not (i[2] == "EXIT" and not i[1])]
    with pytest.raises(ValueError, match="no unguarded EXIT"):
        sass.site_path(no_exit)


# a kernel shaped like a probe's: a load loop, then a loop over rolls that
# holds an inner loop of shared-memory moves and a barrier, then the stores
_LOOPS = """
\t\tFunction : _Z4rollPf
        /*0000*/                   LDG.E.128 R4, [R2.64] ;                    /* 0x0000000402047981 */
        /*0010*/                   STS.128 [R0], R4 ;                         /* 0x0000000400007388 */
        /*0020*/               @P0 BRA 0x0000 ;                               /* 0x0000000000000947 */
        /*0030*/                   LDS.128 R8, [R0] ;                         /* 0x0000000000087984 */
        /*0040*/                   STS.128 [R1], R8 ;                         /* 0x0000000801007388 */
        /*0050*/               @P1 BRA 0x0030 ;                               /* 0x0000000000041947 */
        /*0060*/                   WARPSYNC.ALL ;                             /* 0x0000000000007948 */
        /*0070*/               @P2 BRA 0x0030 ;                               /* 0x0000000000042947 */
        /*0080*/                   STG.E.128 [R2.64], R8 ;                    /* 0x0000000802007986 */
        /*0090*/                   EXIT ;                                     /* 0x000000000000794d */
        /*00a0*/                   BRA 0x00a0;                                /* 0xfffffffc00fc7947 */
"""


def test_loops_gives_each_backward_branch_its_body():
    found = sass.loops(sass.functions(_LOOPS)["_Z4rollPf"])
    assert [(a, b) for a, b, _ in found] == [(0x00, 0x20), (0x30, 0x50), (0x30, 0x70)]
    assert found[0][2] == collections.Counter({"LDG": 1, "STS": 1, "BRA": 1})
    # the loop over rolls holds the inner loop's moves and the barrier
    assert found[2][2] == collections.Counter({"LDS": 1, "STS": 1, "BRA": 2, "WARPSYNC": 1})


# a kernel shaped like a temporal pass's level: a loop over sites whose
# body holds a forcing block that only some sites enter, an IEEE
# division's fast path beside its called slow path, the shared stores and
# the backward branch; then the exit
_LEVEL = """
\t\tFunction : _Z5levelPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;                     /* 0x00000a0000017a02 */
        /*0010*/                   LDS R2, [R0] ;                             /* 0x0000000000027984 */
        /*0020*/               @P1 BRA 0x0040 ;                               /* 0x0000000000041947 */
        /*0030*/                   FADD R2, R2, R4 ;                          /* 0x0000000402027221 */
        /*0040*/                   MUFU.RCP R6, R2 ;                          /* 0x0000000200067308 */
        /*0050*/              @!P0 BRA 0x0070 ;                               /* 0x0000000000048947 */
        /*0060*/                   CALL.REL.NOINC 0x00e0 ;                    /* 0x0000000000107944 */
        /*0070*/                   FMUL R7, R6, R2 ;                          /* 0x0000000206077220 */
        /*0080*/                   STS [R0], R7 ;                             /* 0x0000000700007388 */
        /*0090*/                   IADD3 R2, R2, 0x4, RZ ;                    /* 0x0000000402027810 */
        /*00a0*/                   IADD3 R0, R0, 0x100, RZ ;                  /* 0x0000010000007810 */
        /*00b0*/               @P3 BRA 0x0010 ;                               /* 0x0000000000043947 */
        /*00c0*/                   EXIT ;                                     /* 0x000000000000794d */
        /*00d0*/                   BRA 0x00d0;                                /* 0xfffffffc00fc7947 */
        /*00e0*/                   FADD R9, R9, R9 ;                          /* 0x0000000909097221 */
        /*00f0*/                   RET.REL.NODEC R10 0x0 ;                    /* 0xffffff8c0a007950 */
"""


def test_loop_path_walks_an_ordinary_sites_trip_through_a_level():
    """One trip through the loop over sites: around the forcing block and
    the division's slow path, to the backward branch; nothing before the
    loop or after it is counted."""
    instrs = sass.functions(_LEVEL)["_Z5levelPf"]
    [(first, branch, _)] = sass.loops(instrs)
    assert (first, branch) == (0x10, 0xb0)
    path = sass.loop_path(instrs, first, branch)
    assert path["MOV"] == path["EXIT"] == path["FADD"] == 0
    assert path["MUFU"] == path["FMUL"] == 1
    assert path == collections.Counter({"LDS": 1, "BRA": 3, "MUFU": 1, "FMUL": 1, "STS": 1,
                                        "IADD3": 2})


def test_loop_path_counts_an_inner_loop_once():
    """The loop over rolls of the probe-shaped kernel: its inner loop's
    branch falls through, so each body instruction counts once."""
    instrs = sass.functions(_LOOPS)["_Z4rollPf"]
    path = sass.loop_path(instrs, 0x30, 0x70)
    assert path == collections.Counter({"LDS": 1, "STS": 1, "BRA": 2, "WARPSYNC": 1})


def test_loop_path_needs_its_branch_inside_the_loop():
    instrs = sass.functions(_LEVEL)["_Z5levelPf"]
    with pytest.raises(ValueError, match="not reachable inside its loop"):
        sass.loop_path(instrs, 0x80, 0x50)


# a level whose solid sites branch around the collision: the path with the
# fewest FP32 instructions skips the division, a fluid site's takes it
_CLASSES = """
\t\tFunction : _Z7classesPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;                     /* 0x00000a0000017a02 */
        /*0010*/                   LDS R2, [R0] ;                             /* 0x0000000000027984 */
        /*0020*/               @P1 BRA 0x0070 ;                               /* 0x0000000000041947 */
        /*0030*/                   FADD R2, R2, R4 ;                          /* 0x0000000402027221 */
        /*0040*/                   MUFU.RCP R6, R2 ;                          /* 0x0000000200067308 */
        /*0050*/                   FMUL R7, R6, R2 ;                          /* 0x0000000206077220 */
        /*0060*/                   FADD R7, R7, R4 ;                          /* 0x0000000407077221 */
        /*0070*/                   STS [R0], R7 ;                             /* 0x0000000700007388 */
        /*0080*/                   IADD3 R0, R0, 0x100, RZ ;                  /* 0x0000010000007810 */
        /*0090*/               @P3 BRA 0x0010 ;                               /* 0x0000000000043947 */
        /*00a0*/                   EXIT ;                                     /* 0x000000000000794d */
"""


def test_loop_path_through_an_opcode_takes_a_fluid_sites_trip():
    """Without `through` the walk takes the solid sites' branch around the
    collision (no division); through "MUFU" it takes the fluid sites' trip,
    the reciprocal counted once; through an opcode the loop lacks it
    raises."""
    instrs = sass.functions(_CLASSES)["_Z7classesPf"]
    [(first, branch, _)] = sass.loops(instrs)
    solid = sass.loop_path(instrs, first, branch)
    assert solid == collections.Counter({"LDS": 1, "BRA": 2, "STS": 1, "IADD3": 1})
    fluid = sass.loop_path(instrs, first, branch, through="MUFU")
    assert fluid == collections.Counter({"LDS": 1, "BRA": 2, "FADD": 2, "MUFU": 1, "FMUL": 1,
                                         "STS": 1, "IADD3": 1})
    with pytest.raises(ValueError, match="through a LDGSTS"):
        sass.loop_path(instrs, first, branch, through="LDGSTS")


def test_kernel_key_drops_the_anonymous_namespace_tag():
    """Two builds of one kernel from differently named sources give two
    namespace tags and one key: the kernel's own name and signature."""
    a = ("_ZN56_GLOBAL__N__d44e22f9_23_lbm_ds_temporal_step_cu_6f75cbfa"
         "21lbm_ds_temporal_stepsILb0EEvPKf")
    b = "_ZN45_GLOBAL__N__0badc0de_16_lbm_other_cu_12345678" "21lbm_ds_temporal_stepsILb0EEvPKf"
    assert sass.kernel_key(a) == sass.kernel_key(b) == "21lbm_ds_temporal_stepsILb0EEvPKf"
    assert sass.kernel_key("_Z6kernelPf") == "_Z6kernelPf"


def test_digests_tell_kernels_apart_and_ignore_what_follows_the_listing():
    """One digest per kernel; an instruction changed changes only its
    kernel's digest; what follows a listing's row of dots (the next
    object's header) changes nothing, nor does the column the encodings
    are padded to (cuobjdump pads to an object's widest instruction)."""
    base = sass.digests(_LISTING)
    assert set(base) == {"_Z6kernelPf", "_Z5otherv"}
    assert base["_Z6kernelPf"] != base["_Z5otherv"]
    changed = sass.digests(_LISTING.replace("FMUL R7, R6, R2", "FMUL R7, R6, R3"))
    assert changed["_Z6kernelPf"] != base["_Z6kernelPf"]
    assert changed["_Z5otherv"] == base["_Z5otherv"]
    trailer = _LISTING.replace("\t\t..........\n", "\t\t..........\nFatbin elf code:\narch = sm_90a\n")
    assert sass.digests(trailer) == base
    assert sass.digests(_LISTING.replace(" ;  ", " ;   ")) == base
    assert sass.digests(_LISTING.replace("R7, R6", "R7,R6")) != base
