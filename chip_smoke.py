"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure:
1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles the sources of csrc/ (lbm_step.cu, lbm_wide_step.cu,
   lbm_wide_ext_step.cu, lbm_ds_step.cu, lbm_ds_temporal_step.cu,
   lbm_flat_step.cu, lbm_temporal_step.cu, lbm_probes.cu)
   with nvcc, one process each, all started together (timed), and prints
   ptxas's registers and spills for every kernel instantiation;
3. the float32 stream-collide kernel against its plain PyTorch version
   (fused_kernel.step_reference) on the card, one step at a time from
   identical inputs, at four scenes, plane and wall-free variants; they
   must agree bitwise. Here and in phases 9-12 and 21 both forms of the
   single-chip kernel are held against step_reference and against each
   other: the wide form (lbm_wide_step.cu: several columns per thread,
   16-byte accesses) and the narrow form (lbm_step.cu: one site per
   thread); also at a scene one thread wide (NY == the wide form's column
   count) and at 24x37, which only the narrow form takes (the wide form
   must refuse it);
4. the main path: Simulation(backend="cuda") on the 800x4000 reference
   scene (the wall spec variant, as the JAX main path) for 10,000 steps
   after a warmup, every step a counted kernel launch of the form
   fused_kernel.kernel_form names; the state must be finite and
   non-negative and Re finite, and a 20-step run must match the "torch"
   backend on the same card. Then the same path at 800x4002, an NY the
   wide form does not take, NARROW_STEPS counted launches of the narrow
   form, held the same way;
5. times at 800x4000 of both forms' plane and spec variants (in turns),
   their plain versions, the plain "torch" engine, and the roofline's
   denominator: the port's copy kernel on one state buffer (its best
   form), with Tensor.copy_, the library's copy, beside it;
6. the pair-DP (ds) kernel against its plain version
   (fused_ds_kernel.step_reference) on the card, both tiers (fast and
   exact) and both variants, 10 single steps each at the four scenes of
   phase 3 from a perturbed float64 state split into pairs; bitwise;
   then chains from rest at 800x4000, 100 fast and 50 exact steps, on the
   reference scene, on a symmetric channel without an obstacle (the
   cross-channel velocity stays near zero, where the kernel's one-FMA
   products meet Dekker's at the edge of their common domain) and on an
   empty box (the wall-free variant): the kernel's chain bitwise equal to
   step_reference's at the end;
7. the ds main path: Simulation(backend="cuda-ds64") on the 800x4000
   reference scene for 10,000 steps after a warmup, in passes of
   DS_TEMPORAL = 4 steps through the ds kernel's temporal form, every
   pass a counted launch (2,524) and every step counted in its passes, no
   one-step launch; the state must be finite and non-negative and Re
   finite, and a 200-step run from rest must match the float64 "torch"
   backend on the same card within 1e-11 relative; then the same path at
   800x4002, an NY the temporal form does not take, NARROW_STEPS counted
   launches of the one-step kernel;
8. times at 800x4000 of the one-step ds kernel at each tier, its plain
   versions, the eager "torch-ds64" engine, and the ds main path's slope
   (passes of 4); the ds
   kernels' instructions per site, counted in their SASS (cuobjdump) along
   the path of an ordinary site (utils/sass.py: past the forcing branches
   and the division's slow path), the bound they give and their issue
   floor at the SM clock read under load;
9. the bf16-storage kernel against step_reference, bitwise, at the four
   scenes of phase 3, plane and wall-free variants;
10. the spec variant against the plane variant and step_reference,
   bitwise, at the reference, cylinder and channel scenes (800x4000), in
   float32 and bf16;
11. the slip codes, bitwise against step_reference, on a channel whose
   top wall row is slip_x with a slip_y block (float32 and bf16); then
   the slip path through Simulation(slip_x=, slip_y=), counted, and
   against the "torch" backend's slip path;
12. fast math: the approximate-1/rho variant against step_reference
   (IEEE) after 10 chained steps, within fused_kernel.FAST_MATH_RTOL; then the
   Simulation(fast_math=True) path, counted;
13. the bf16 main path: Simulation(LatticeConfig(800, 4000,
   dtype="bfloat16"), backend="cuda") for 10,000 steps after a warmup,
   every step a counted launch of the form kernel_form names; finite and
   non-negative, Re finite, and within the JAX package's bf16 bar of the
   float32 main path of phase 4 after the same steps; a 20-step run
   within that bar of the bf16 "torch" backend; then the narrow form's
   path at 800x4002 as in phase 4;
14. times, both forms in turns: the bf16 spec and plane variants at
   800x4000, the bf16 spec variant at 4000x16000, each as a share of the
   copy kernel's rate on a bf16 state of that size, the bf16 plain
   versions, the slip and fast-math variants beside theirs;
15. the ext-halo forms of both kernels (the row-sharded path) against
   their plain versions (step_reference_ext) on meshes of 2 and 4
   virtual shards of the card, 10 single steps at the four scenes of
   phase 3, with the forcing guard off at column 0 on both sides of a
   shard boundary: float32 wall-free, plane, spec and slip, bf16 plane and
   spec, ds fast and exact tiers, bitwise. Both forms of the
   stream-collide kernel's (wide: lbm_wide_ext_step.cu, several columns
   per thread, 16-byte accesses; narrow: lbm_step.cu, one site per
   thread) from the same input each step, each against step_reference_ext
   and the other, the wide one also against step_reference_ext_wide; fast
   math on 4 shards within FAST_MATH_RTOL of the IEEE single-chip plain
   version;
16. the sharded main paths on the 800x4000 reference scene, every launch
   counted by variant and by form: sharded-cuda over 1 and 4 virtual
   shards for WARMUP + MAIN_STEPS steps, each shard's interior launch of
   the wide form and its two one-row launches of the narrow form (the
   launcher's default), bitwise equal to phase 4's cuda state; sharded-cuda-fused over 4
   shards, FUSED_STEPS steps, and sharded-cuda-ds64 over 4 shards,
   DS_SHARDED_STEPS steps in passes of DS_TEMPORAL = 4 through the ds
   kernel's ext-halo temporal form (one launch per shard and pass, the
   4-row halos copied once per pass), bitwise equal to cuda and
   cuda-ds64; with two or more cards also a mesh of the cards. Then
   sharded-cuda and sharded-cuda-rdma over 4 virtual shards at 800x4002,
   an NY the wide forms do not take, NARROW_SHARDED_STEPS steps, every
   launch of the narrow form, bitwise equal to cuda there, and
   sharded-cuda-ds64 there, every step one launch per shard of the
   one-step ds ext-halo form, bitwise equal to cuda-ds64 there;
17. times: us/step of each sharded path beside cuda and cuda-ds64, in
   turns, with the host's enqueue time; the halo exchange per step (per
   pass of 4 for sharded-cuda-ds64); the
   ext-halo kernels' launches of one step (interior + edges, or one per
   shard; both forms of the stream-collide kernel's, and the default mix,
   in float32 and bf16, in turns; the ds kernel's too) beside the
   single-chip launch, as the
   host launches them and queued behind a spin (the card's own time), and
   their plain versions;
18. the four anatomy probes (ops/probes.py) against their plain versions,
   bitwise, from seeded random inputs: the copy kernel (direct and
   staged forms, float32 and bf16, at 800x4000, 24x40 and 24x37, an odd
   NY), the alignment kernel (offsets 0, 1, 2 along rows and along
   columns), the y-roll kernel at (32, 4000), (32, 40) and (32, 37) and
   the x-roll kernel at (40, 4000), (40, 40) and (40, 37): both forms of
   the shared-memory mechanism (wide: 16-byte vectors, the y-roll's rows
   across a thread-block cluster of 4 CTAs; narrow: a row or a 128-column
   tile per CTA, 4-byte accesses) and form=None (the y-roll's narrow
   form, the x-roll's wide one: the faster on an H100), and the
   shuffle and global mechanisms, at shifts of every residue mod 4 (1, 2,
   3, 4, 5, 96, NY-1, NY-2, NY; the x-roll also 1 and R-1) and 0, 1, 6, 7
   rolls (the x-roll also 8, 9), each also against one torch.roll by the
   summed shift; launches counted by form: the wide forms must run at
   4000 columns, the narrow ones at 37, where form="wide" must refuse
   (the wide y-roll also at 40, no multiple of 16); the wide y-roll's
   cudaOccupancyMaxActiveClusters; the SASS of the wide kernels: each
   one's loop over rolls holds its shared loads and its shared (or
   cluster) stores, and the y-roll's also its mbarrier waits;
19. the flat multi-step kernel (T steps a pass in shared memory) against
   flat_reference, bitwise, the whole stacked pair, on the wall-free
   scenes of phase 3, a lattice smaller than one tile (5x3) and a ragged
   one (37x1001), float32 and bf16, 2 and 8 steps in one launch, at T in
   1, 2, 3, 4, 8 and each storage type's default (FLAT_TEMPORAL), and
   against flat_reference_blocked (the kernel's tiling in plain PyTorch,
   at the kernel's tile) on all but the 800x4000 scene; then at full
   width: 800x4000 wall-free
   float32, 1,008 steps in 63 counted launches of 16 through
   make_flat_step, bitwise equal to Simulation(backend="cuda") on
   geometry.empty after the same steps;
20. the anatomy path itself, scripts.anatomy.main(--section all) with a
   small --steps at 800x4000, every kernel's launches counted; then
   times: the copy kernel's forms beside Tensor.copy_ in turns, ns per
   roll and per add of the probes (slopes between two counts; both
   forms of each roll in turns), one
   launch of each roll at the JAX probe's count (6 y-rolls, 8 x-rolls)
   of each form queued behind a spin in turns beside one torch.roll by
   the summed shift, and the
   flat kernel's us/step beside the step kernel's, in turns, at 800x4000
   float32 and bf16 and at 400x2000 bf16 (both parities in L2), with its
   temporal depth, tile, CTAs per SM, shared bytes and registers;
21. one float32 step at 4000x16000 (the shape the TPU kernel needed lane
   panels for), spec and wall-free variants, both forms, bitwise against
   step_reference.

22. the rdma form of the stream-collide kernel (the halo exchange inside
   the kernel: one launch per shard and step, each shard on a stream of
   its own, no copy from the host), both forms (wide and narrow, as in
   phase 15), against step_reference_rdma on 2 and 4 virtual shards, 10
   steps at the four scenes of phase 3, the comm rows each shard received
   included: float32 wall-free, plane, spec and slip, bf16 plane and spec,
   bitwise, the wide form also against its plain version and the two
   forms' states against each other; fast math on 4 shards within
   FAST_MATH_RTOL; then a withheld send (one shard of two launched) must
   end in a raised timeout and not in a hang;
23. the rdma path, inside phase 16: Simulation(backend=
   "sharded-cuda-rdma", allow_experimental=True) over 4 virtual shards on
   the 800x4000 reference scene for WARMUP + MAIN_STEPS steps, 4 counted
   launches of the wide form and 0 halo copies per step, bitwise equal to
   phase 4's cuda state (and so to sharded-cuda's); with two or more cards
   also over a mesh of the cards (peer pointers), else a line says that it
   was not run; and at 800x4002 in the narrow form, as phase 16;
24. its times, inside phase 17: us/step and host enqueue us/step in turns
   with cuda, sharded-cuda and sharded-cuda-fused, and one step's 4 rdma
   launches of each form queued behind a spin, in turns, beside the
   ext-halo form's 4 launches, in float32 and bf16.
Phases 22-24 run with phases 15-17 (sharded_phases); phase 30's entry
stands beside phase 6-8's in the kernels line.
25. the probed main path: Simulation(backend="cuda").run_probed on the
   800x4000 reference scene at the three wake probes of
   scripts/numerics_tiers.py, PROBED_STEPS steps at every = 1, 8 and 3;
   the series bitwise equal to the same launches run by run() with
   probe_values between chunks, the final state bitwise equal to an
   unprobed run's, exactly PROBED_STEPS launches counted, all from
   phase 4's state after its 10,096 steps (the wake has reached the
   probes); the same on
   "cuda" with bf16 storage, on "cuda-ds64" (series in float64 from the
   pair's probe columns), on "sharded-cuda-rdma" over VIRTUAL_SHARDS
   virtual shards (series also bitwise equal to "cuda"'s, 4 launches per
   step) and on "sharded-cuda-ds64" over VIRTUAL_SHARDS virtual shards
   (series also bitwise equal to "cuda-ds64"'s; passes of 4 and one of
   the rest per sample, one launch per shard and pass);
   then us/step of run_probed and of run() in turns, at every = 1
   and 8, and the gather's cost per sample;
26. every row of latticeboltzmann_tpu_torch/bench_suite.py once at its
   --quick length (bench_suite.QUICK_STEPS steps, the float64 rows too), every row
   sane, each row's line and the phase's wall time printed, the launches
   of every kernel route the rows take counted;
27. scripts/validate_ds.py at 400x2000 for 2,000 steps: cuda-ds64 against
   the float64 torch engine, Re within 1e-9 relative;
28. the CLI (python -m latticeboltzmann_tpu_torch) in process through
   cli.main at 800x4000, under a temporary directory in build/: (a) cuda
   f32 for CLI_STEPS steps with |u|^2 snapshots and checkpoints every
   CLI_EVERY, the three wake probes every CLI_PROBE_EVERY, a
   torch.profiler trace and --debug-nans, then --resume latest for
   CLI_EVERY steps: its checkpoint's f.raw byte-equal to an unbroken CLI
   run's, every step and warmup step a counted launch of the wide form,
   the snapshots byte-equal to write_snapshot_csv of a Simulation run's
   speed_squared(), probes.csv bitwise equal to run() + probe_values, and
   the trace (entered before the warmup, closed after the last chunk's
   events) naming lbm_stream_collide_wide once per launch and holding
   one lbm_warmup span and an lbm_run span per chunk; (b) bf16 cuda,
   cuda-ds64 and sharded-cuda-rdma over the visible cards, CLI_OTHER_STEPS
   steps and a resume of as many against an unbroken run (bitwise; the
   ds pair, split again from float64 at load, else within DS_RTOL, and
   the line says which bar held), launches counted, snapshots finite;
   (c) a NaN planted in one site of a checkpoint, resumed with
   --debug-nans: exit 1 after the first chunk, the step named; (d)
   --checkpoint-format orbax (and --movie where matplotlib does not
   import) refused with exit 2 and no launch, the movie where it
   imports, and the host IO times at 800x4000 of a snapshot CSV through
   both paths of utils/native.py's writer (the C++ library, NumPy) and
   of a checkpoint save and load, with the phase's wall time. Phase 28's
   launches of each kernel stand beside its entry's launches in the
   kernels line (cli_launches; the rdma kernel's CLI runs are a ring of
   cli_cards cards);
29. the main path's temporal blocking (temporal_phases; the temporal form
   of the stream-collide kernel, csrc/lbm_temporal_step.cu: a pass of L
   steps with walls per launch): its tile, registers and spills; one pass
   at every L the card's tile takes, f32 and bf16, bitwise against the
   chain of step_reference (and the tiled plain version
   temporal_reference_blocked on small lattices) at phase 3's scenes, the
   reference barrier as plane and spec, slip codes, a lattice smaller
   than one tile and one ragged in both axes; fast math within its bar;
   us/step of Session(temporal=T) in turns for T in TEMPORAL_DEPTHS and
   the deepest pass, f32 and bf16, spec and plane at 800x4000, bf16 at
   4000x16000 and f32 at 400x2000 (the pace by CUDA events, the card's
   time queued behind a spin, the host's enqueue); then the main path,
   Simulation(backend="cuda", temporal=T) at the fastest T >= 2, f32 and
   bf16: WARMUP + MAIN_STEPS steps bitwise equal to phases 4 and 13's
   states in exactly (WARMUP + MAIN_STEPS) // T counted passes of T steps
   and one of the rest (no one-step launch), run_probed at every = 1, 8
   and 3 bitwise equal to temporal=None's, and a run split at a step
   count no multiple of T bitwise equal to the unsplit one;
30. the pair-DP path's temporal form (ds_temporal_phase; the ds kernel's
   temporal form, csrc/lbm_ds_temporal_step.cu: a pass of L pair steps
   per launch): its tiles (two CTAs of 256 threads an SM, one of 512),
   registers and spills at both tiers, masked and wall-free; one pass at every L each tile
   takes, both tiers, masked and wall-free, bitwise against the chain of
   step_reference at 5x8, 37x64, 45x1000 (ragged) and 800x4000 and
   against temporal_reference_blocked at the card's tiles on the small
   lattices; chains from rest at 800x4000 in passes of 4 (100 fast and 50
   exact steps; barrier, symmetric channel, empty box) bitwise; phase 7's
   main path bitwise equal to a temporal=1 session's 10,096 counted
   one-step launches, and a split run; us/step by CUDA events in turns
   with the one-step kernel for T = 1-4 and each tile's deepest pass, both
   tiers at 800x4000 and the fast tier at 400x4000, each beside its
   bounds (bytes per pass at the published rate and the copy kernel's,
   the issue floor times the levels' recompute);
31. the pair-DP shard pass (ds_sharded_temporal_phase; the ds kernel's
   ext-halo temporal form, csrc/lbm_ds_temporal_step.cu's
   lbm_ds_temporal_steps_ext: a pass of L pair steps on a shard, the rows
   beyond it from Td-row pair halos): its tile, registers and spills at
   both tiers, masked and wall-free; one pass at every L 1-4 with 4-row
   halos (and the deepest at halos of that depth on rings of one shard),
   both tiers, masked and wall-free, every row range of both schedules
   (the whole shard; the interior and two L-row bands), bitwise against
   the chain of step_reference on the halo-extended block, on rings of
   1, 2 and 4 virtual shards at 800x4000, 2 shards of 5x8 and one of
   37x64, and against temporal_reference_ext_blocked at the card's tile
   on the small lattices; the main path, sharded-cuda-ds64 over 4 virtual
   shards (and 4 cards where there are 4, else a line says so) for
   DS_SHARDED_STEPS steps in counted passes of 4, no one-step launch,
   bitwise equal to cuda-ds64 and to a temporal=1 sharded session; the
   path's us/step and enqueue in turns at temporal=1 and at passes of 4
   with overlap=True and overlap=False beside cuda-ds64, on 4 virtual
   shards and on one shard; the halo exchange alone per pass; one pass's
   launches at L 1-4 queued behind a spin beside the local temporal
   form's pass, each with its bounds.

Every phase call of main() prints `phase N took S s` (N: the phases it
runs, e.g. 6-8) on its own line, and a `phase seconds` line before the
bounds line gathers them.

The kernels line gives every kernel's bound (the temporal form's for one
pass: the state read and written once, every level's operations): the
larger of its bytes (each input read once, each output written once)
over the card's published memory rate and its f32 operations over the
published f32 rate (PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S; the ds
kernels' operations are counted in their SASS, an FFMA as two). Besides
bound_ms, every number in the line was measured in the run. The other
bounds the phases compute from their inputs (computed_bounds: the ds
kernels' issue floor, the FP32 instructions over one a lane and clock;
the shared-memory or L1 bound per roll or add of the three on-chip
probes over all of the card's SMs, and over the SMs of the narrow roll's
launch; the flat kernel's bound when every step goes through device
memory; the bf16 bounds of the ext-halo and rdma forms) stand on the
line before it, by kernel, and the temporal form's shared-memory bound
of its levels on phase 29's own line. The roll entries carry the default form, each form's time per
launch and per roll, the library call's, and the wide form's shape
(cluster size, or vectors and warps per CTA). The line before the last
is the card's name and power limit; the last is {"ok": true, "device":
{...}}. Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from latticeboltzmann_tpu_torch.utils.timing import event_ms, queued_ms, timed_slope

MAIN_STEPS = 10_000
WARMUP = 96
SEED = 0
# the kernel is built with -fmad=false and IEEE division, and its bf16
# stores round to nearest even as torch's casts do, so it rounds exactly
# like step_reference: bitwise agreement is the bar (fast math excepted)
KERNEL_ATOL = 0.0
# the JAX package's pallas-vs-xla bar after 20 steps
# (tests/test_pallas.py:74-81): the two engines associate differently
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-7
# the JAX package's pair-DP bar: the fast tier against a float64 engine
# after 200 steps (tests/test_ds.py:213-229)
DS_RTOL = 1e-11
DS_COMPARE_STEPS = 200
# the JAX package's bf16 bar against float32 (tests/test_pallas.py:142-157)
BF16_RTOL, BF16_ATOL = 0.05, 2e-3
# fast math's bar (no bitwise reference) is fused_kernel.FAST_MATH_RTOL
# after fused_kernel.FAST_MATH_STEPS chained steps
# steps of the slip and fast-math paths through the facade
OPTION_STEPS = 1000
# the narrow form's path: an NY that is no multiple of the wide form's
# column counts, and its steps; the sharded paths' steps there
NARROW_NY = 4002
NARROW_STEPS = 1000
NARROW_SHARDED_STEPS = 500
# the sharded paths held against a single-chip path other than phase 4's
FUSED_STEPS = 1000
DS_SHARDED_STEPS = 2000
# virtual shards of one card on the sharded main paths (200-row shards)
VIRTUAL_SHARDS = 4
# steps per timed run of the rdma launches (phase 24)
RDMA_TIMED_STEPS = 50
# the bound's denominators: one H100 SXM's published rates (NVIDIA's data
# sheet): HBM bytes per second and float32 operations per second outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations per site update of the stream-collide kernel: the
# reference's 124 FLOP (the ds kernels' are counted in their SASS)
F32_OPS_PER_SITE = 124
# float32 lanes of one Hopper SM: the issue floor's instructions per clock
FP32_LANES_PER_SM = 128
# steps of the ds kernel's chains from rest (phase 6), by tier (exact?)
DS_LONG_STEPS = {False: 100, True: 50}
# the probed main path (phase 25): steps (a multiple of every value of
# PROBED_EVERY), the sampling intervals, and the timed runs' steps
PROBED_STEPS = 240
PROBED_EVERY = (1, 8, 3)
PROBED_TIMED_STEPS = 2000


def computed_bounds(entry):
    """Take out of a kernels-line entry the bounds its phase computed from
    the run's inputs besides bound_ms (and bound_by): the keys that name
    a bound or an issue floor. Returns them, by key."""
    keys = [k for k in entry if k not in ("bound_ms", "bound_by")
            and ("bound" in k or "issue_floor" in k)]
    return {k: entry.pop(k) for k in keys}


def bound(n_bytes, n_ops):
    """The kernels line's bound keys for work that moves n_bytes and does
    n_ops float32 operations: the larger of the two times at the card's
    published rates, which of them it is, and library_ms, None: no single
    PyTorch call computes a fused lattice-Boltzmann step."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def ds_site_counts():
    """{(kernel, has_walls, exact): opcode counts along an ordinary site's
    path} for the ds kernels (kernel "ds" or "ds_ext") of the built
    library, read from its SASS; prints a line for each."""
    import re

    from latticeboltzmann_tpu_torch.ops import cuda_build
    from latticeboltzmann_tpu_torch.utils import sass

    out = {}
    for name, instrs in sass.functions(sass.disassemble(cuda_build.build())).items():
        m = re.search(r"lbm_stream_collide_(ds|ds_ext)ILb([01])ELb([01])E", name)
        if not m:
            continue
        key = (m.group(1), m.group(2) == "1", m.group(3) == "1")
        path = sass.site_path(instrs)
        if not path["MUFU"]:
            raise AssertionError(f"{name}: no division on the site path: {dict(path)}")
        out[key] = path
        print(f"ds SASS, {key[0]} {'masked' if key[1] else 'wall-free'} "
              f"{'exact' if key[2] else 'fast'}: per site FADD {path['FADD']}, FMUL "
              f"{path['FMUL']}, FFMA {path['FFMA']}, MUFU {path['MUFU']} (FP32 "
              f"{sum(path[k] for k in sass.FP32)}), all instructions {sum(path.values())}; "
              f"the whole kernel {len(instrs)}")
    if len(out) != 8:
        raise AssertionError(f"found {sorted(out)} of the 8 ds kernels in the SASS")
    return out


def sm_clock_mhz(fn, n):
    """The SM clock (MHz) nvidia-smi reads while n calls of fn run."""
    import subprocess

    for _ in range(n):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    return float(out.split()[0])


def counted_bound(n_bytes, path, sites, clock_mhz):
    """bound() for work that moves n_bytes and runs `path` (opcode counts
    per site, ds_site_counts) at `sites` sites: an FFMA is two operations,
    FADD, FMUL and MUFU one; with the issue floor, the FP32 instructions
    at one a lane and clock of the card's SMs at clock_mhz."""
    from latticeboltzmann_tpu_torch.utils import sass

    fp32 = sum(path[k] for k in sass.FP32)
    ops = fp32 + path["FFMA"]
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * FP32_LANES_PER_SM
    return {**bound(n_bytes, ops * sites),
            "ops_per_site": ops, "fp32_instructions_per_site": fp32,
            "instructions_per_site": sum(path.values()),
            "issue_floor_ms": fp32 * sites / (lanes * clock_mhz * 1e6) * 1e3,
            "sm_clock_mhz": clock_mhz}


def perturbed_state(cfg, rng):
    """Rest equilibrium times (1 + 5% uniform noise), as float32 (a bf16
    config's state is rounded to bf16 when it is loaded): non-zero
    velocities everywhere, so every term of the collision is exercised."""
    from latticeboltzmann_tpu_torch.models.engine import initial_state

    f = initial_state(cfg)
    return (f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))).astype(np.float32)


def reset_counts():
    """Every kernel launch count to 0."""
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel, fused_kernel, probes

    fused_kernel.LAUNCHES = fused_ds_kernel.LAUNCHES = 0
    fused_kernel.EXT_LAUNCHES = fused_ds_kernel.EXT_LAUNCHES = 0
    fused_ds_kernel.TEMPORAL_LAUNCHES = fused_ds_kernel.TEMPORAL_STEPS = 0
    fused_ds_kernel.EXT_TEMPORAL_LAUNCHES = fused_ds_kernel.EXT_TEMPORAL_STEPS = 0
    fused_kernel.FLAT_LAUNCHES = fused_kernel.RDMA_LAUNCHES = 0
    fused_kernel.TEMPORAL_LAUNCHES = fused_kernel.TEMPORAL_STEPS = 0
    fused_kernel.TEMPORAL_VARIANT_LAUNCHES.clear()
    fused_kernel.VARIANT_LAUNCHES.clear()
    fused_kernel.FORM_LAUNCHES.clear()
    fused_kernel.EXT_VARIANT_LAUNCHES.clear()
    fused_kernel.EXT_FORM_LAUNCHES.clear()
    fused_kernel.RDMA_VARIANT_LAUNCHES.clear()
    fused_kernel.RDMA_FORM_LAUNCHES.clear()
    probes.LAUNCHES.clear()
    probes.ROLL_FORM_LAUNCHES.clear()


def read_counts():
    """{variant: launches} of the stream-collide kernel, its ext-halo
    form's as "ext-<variant>", its rdma form's as "rdma-<variant>", its
    temporal form's as "temporal-<variant>", the ds kernel's under "ds"
    (one step a launch), "ds-temporal" (passes of the temporal form),
    "ds-ext" (the one-step ext-halo form) and "ds-ext-temporal" (passes of
    the ext-halo temporal form), the flat kernel's under "flat" and the probes' under their
    own keys ("copy-direct", "roll_y-shuffle", ...)."""
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel, fused_kernel, probes

    counts = dict(fused_kernel.VARIANT_LAUNCHES)
    if sum(counts.values()) != fused_kernel.LAUNCHES:
        raise AssertionError(f"variant counts {counts} != {fused_kernel.LAUNCHES} launches")
    ext = dict(fused_kernel.EXT_VARIANT_LAUNCHES)
    if sum(ext.values()) != fused_kernel.EXT_LAUNCHES:
        raise AssertionError(f"ext variant counts {ext} != {fused_kernel.EXT_LAUNCHES} launches")
    counts.update({f"ext-{v}": n for v, n in ext.items()})
    rdma = dict(fused_kernel.RDMA_VARIANT_LAUNCHES)
    if sum(rdma.values()) != fused_kernel.RDMA_LAUNCHES:
        raise AssertionError(f"rdma variant counts {rdma} != {fused_kernel.RDMA_LAUNCHES} launches")
    counts.update({f"rdma-{v}": n for v, n in rdma.items()})
    temporal = dict(fused_kernel.TEMPORAL_VARIANT_LAUNCHES)
    if sum(temporal.values()) != fused_kernel.TEMPORAL_LAUNCHES:
        raise AssertionError(f"temporal variant counts {temporal} != "
                             f"{fused_kernel.TEMPORAL_LAUNCHES} launches")
    counts.update({f"temporal-{v}": n for v, n in temporal.items() if n})
    if fused_ds_kernel.LAUNCHES:
        counts["ds"] = fused_ds_kernel.LAUNCHES
    if fused_ds_kernel.TEMPORAL_LAUNCHES:
        counts["ds-temporal"] = fused_ds_kernel.TEMPORAL_LAUNCHES
    if fused_ds_kernel.EXT_LAUNCHES:
        counts["ds-ext"] = fused_ds_kernel.EXT_LAUNCHES
    if fused_ds_kernel.EXT_TEMPORAL_LAUNCHES:
        counts["ds-ext-temporal"] = fused_ds_kernel.EXT_TEMPORAL_LAUNCHES
    if fused_kernel.FLAT_LAUNCHES:
        counts["flat"] = fused_kernel.FLAT_LAUNCHES
    counts.update({k: n for k, n in probes.LAUNCHES.items() if n})
    return counts


def expect_counts(label, want, form=None):
    """Raise unless the launch counts are `want`; with `form`, also unless
    the launches of the stream-collide kernel (single-chip, ext-halo and
    rdma forms) took that form: every launch, or for a dict {form:
    launches} of the kind that launched, those counts."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

    got = read_counts()
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected {want}")
    for kind, total, counts in (("single-chip", fk.LAUNCHES, fk.FORM_LAUNCHES),
                                ("ext-halo", fk.EXT_LAUNCHES, fk.EXT_FORM_LAUNCHES),
                                ("rdma", fk.RDMA_LAUNCHES, fk.RDMA_FORM_LAUNCHES)):
        forms = {f: n for f, n in counts.items() if n}
        expected = form if isinstance(form, dict) else {form: total}
        if form is not None and total and forms != expected:
            raise AssertionError(f"{label}: {kind} launches by form {forms}, expected "
                                 f"{expected}")
    return got


def on_card(geom, dev):
    """A geometry for fused_kernel.step: a numpy plane goes to the card,
    None and wall specs stay as they are."""
    return torch.as_tensor(geom, device=dev) if isinstance(geom, np.ndarray) else geom


def reference(src, geom, cfg):
    """step_reference for any geometry source of fused_kernel.step."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel

    if isinstance(geom, tuple):
        return fused_kernel.step_reference(src, None, cfg, wall_spec=geom)
    return fused_kernel.step_reference(src, geom, cfg)


def kernel_forms(a, geom, cfg):
    """The forms of the single-chip kernel that take this launch: the
    narrow form always, the wide form where fused_kernel.kernel_form names
    it; elsewhere asking for the wide form must raise."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel

    pointers = [a.data_ptr()] + ([geom.data_ptr()] if torch.is_tensor(geom) else [])
    if fused_kernel.kernel_form(a.dtype, cfg.ny, pointers) == "wide":
        return ["wide", "narrow"]
    before = fused_kernel.LAUNCHES
    try:
        fused_kernel.step(a, torch.empty_like(a), geom, cfg, form="wide")
    except ValueError:
        if fused_kernel.LAUNCHES == before:
            return ["narrow"]
    raise AssertionError(f"{cfg.nx}x{cfg.ny} {a.dtype}: the wide form does not apply, and "
                         "step(form='wide') did not refuse it")


def worst(errs, new):
    """errs[form] = max(errs[form], new[form]) for compare_kernel's results."""
    for form, e in new.items():
        errs[form] = max(errs.get(form, 0.0), e)
    return errs


def compare_kernel(name, cfg, geom, f0, steps=10):
    """{form: max |kernel - step_reference|} over `steps` single steps,
    each form of the single-chip kernel that takes the scene launched from
    the same input. geom: None (the wall-free variant), an (NX, NY) uint8
    class plane, or a wall spec. Raises unless every form agrees bitwise
    with step_reference at every step, and so with the other form, and
    unless the wide form's plain version (step_reference_wide) does too."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import state_tensor

    dev = torch.device("cuda")
    g = on_card(geom, dev)
    a = state_tensor(f0, cfg.dtype, dev)
    forms = kernel_forms(a, g, cfg)
    err = dict.fromkeys(forms, 0.0)
    spec = {"wall_spec": g} if isinstance(g, tuple) else {}
    for _ in range(steps):
        ref = reference(a, g, cfg)
        if "wide" in forms and not torch.equal(fused_kernel.step_reference_wide(
                a, None if spec else g, cfg, fused_kernel.WIDE_COLUMNS[a.dtype], **spec), ref):
            raise AssertionError(f"{name}: step_reference_wide != step_reference")
        outs = {}
        for form in forms:
            b = outs[form] = torch.full_like(a, float("nan"))
            fused_kernel.step(a, b, g, cfg, form=form)
            d = (b.float() - ref.float()).abs()
            e = float(d.max())
            if not (torch.equal(b, ref) and e <= KERNEL_ATOL):
                bad = torch.nonzero(b != ref)
                per_speed = [float(d[s].max()) for s in range(9)]
                raise AssertionError(
                    f"{name}: {form} kernel != step_reference, max |diff| {e!r} at "
                    f"{bad.shape[0]} values (first {bad[:5].tolist()}), per speed "
                    f"{per_speed}"
                )
            err[form] = max(err[form], e)
        if len(forms) == 2 and not torch.equal(outs["wide"], outs["narrow"]):
            raise AssertionError(f"{name}: the wide form's output != the narrow form's")
        a = ref
    torch.cuda.synchronize()
    kind = "wall-free" if g is None else ("spec" if isinstance(g, tuple) else "plane")
    print(f"kernel vs step_reference {name} ({a.dtype}, {kind}), {steps} steps, forms "
          f"{' == '.join(forms)}{' == step_reference_wide' if 'wide' in forms else ''}: "
          f"max |diff| = {max(err.values())!r}")
    return err


def compare_ds_kernel(name, cfg, walls, f0, exact, steps=10):
    """Max |ds kernel - step_reference| over both pair components and
    `steps` single steps, each from the same input pair."""
    from latticeboltzmann_tpu_torch.ops import df64, fused_ds_kernel

    dev = torch.device("cuda")
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    has_walls = bool(walls.any())
    a = df64.from_f64(f0, dev)
    b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    before = fused_ds_kernel.LAUNCHES
    err = 0.0
    for _ in range(steps):
        fused_ds_kernel.step(a, b, solid, cfg, has_walls=has_walls, exact=exact)
        ref = fused_ds_kernel.step_reference(a.hi, a.lo, solid if has_walls else None, cfg, exact)
        d = torch.maximum((b.hi - ref.hi).abs(), (b.lo - ref.lo).abs())
        e = float(d.max())
        if not e <= KERNEL_ATOL:
            bad = torch.nonzero(d > KERNEL_ATOL)
            raise AssertionError(
                f"{name}: ds kernel ({'exact' if exact else 'fast'}) != step_reference, "
                f"max |diff| {e!r} at {bad.shape[0]} values (first {bad[:5].tolist()})"
            )
        err = max(err, e)
        a, b = b, a
    torch.cuda.synchronize()
    launches = fused_ds_kernel.LAUNCHES - before
    if launches != steps:
        raise AssertionError(f"{name}: {launches} ds kernel launches for {steps} steps")
    print(f"ds kernel vs step_reference {name} ({'exact' if exact else 'fast'} tier, "
          f"{'masked' if has_walls else 'wall-free'}), {steps} steps, {launches} launches: "
          f"max |diff| = {err!r}")
    return err


def long_ds_check(name, cfg, walls, exact, temporal=None):
    """The ds kernel's chain of DS_LONG_STEPS[exact] steps from rest
    against step_reference's chain from the same state: bitwise at the
    end, every step a counted launch of the one-step kernel; with
    `temporal`, the temporal form's chain in passes of `temporal` steps
    and one of the rest, every pass a counted launch."""
    from latticeboltzmann_tpu_torch.models.engine import initial_state
    from latticeboltzmann_tpu_torch.ops import df64, fused_ds_kernel

    dev = torch.device("cuda")
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    has_walls = bool(walls.any())
    ref = df64.from_f64(initial_state(cfg), dev)
    steps = DS_LONG_STEPS[exact]
    before = (fused_ds_kernel.LAUNCHES, fused_ds_kernel.TEMPORAL_LAUNCHES)
    a = df64.DS(ref.hi.clone(), ref.lo.clone())
    b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    if temporal is None:
        for _ in range(steps):
            fused_ds_kernel.step(a, b, solid, cfg, has_walls=has_walls, exact=exact)
            a, b = b, a
        want = (steps, 0)
    else:
        for done in range(0, steps, temporal):
            fused_ds_kernel.temporal_step(a, b, solid, cfg, min(temporal, steps - done),
                                          has_walls=has_walls, exact=exact)
            a, b = b, a
        want = (0, -(-steps // temporal))
    for _ in range(steps):
        ref = fused_ds_kernel.step_reference(ref.hi, ref.lo, solid if has_walls else None, cfg,
                                             exact)
    torch.cuda.synchronize()
    got = (fused_ds_kernel.LAUNCHES - before[0], fused_ds_kernel.TEMPORAL_LAUNCHES - before[1])
    launches = sum(got)
    tier = "exact" if exact else "fast"
    if got != want:
        raise AssertionError(f"{name}: (one-step, temporal) launches {got} for {steps} steps, "
                             f"expected {want}")
    for part in ("hi", "lo"):
        got, want = getattr(a, part), getattr(ref, part)
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want)
            raise AssertionError(
                f"{name}: ds kernel chain ({tier}) != step_reference chain after {steps} steps "
                f"from rest, {part} differs at {bad.shape[0]} values (first {bad[:5].tolist()})")
    u_x = float((a.hi[2] - a.hi[4] + a.hi[5] + a.hi[6] - a.hi[7] - a.hi[8]).abs().max())
    form = "one-step" if temporal is None else f"temporal (passes of {temporal})"
    print(f"ds kernel chain vs step_reference chain {name} ({tier} tier, "
          f"{'masked' if has_walls else 'wall-free'}), {steps} steps from rest, {launches} "
          f"launches of the {form} form: bitwise equal (max |x-momentum|, the cross-channel "
          f"component, {u_x!r})")


def rates_printer(cfg, bps):
    """A printer of one time per step at cfg's size, with MLUPS and the
    effective GB/s at bps bytes per site."""

    def rates(label, sec_per_step):
        mlups = cfg.sites / sec_per_step / 1e6
        print(f"{label}: {sec_per_step * 1e6!r} us/step, {mlups!r} MLUPS, "
              f"{mlups * 1e6 * bps / 1e9!r} GB/s effective ({bps} B/site)")

    return rates


def slope(sim):
    """Seconds per step of a Simulation's run(): the slope between runs of
    1680 and 5040 steps (best of two each), which cancels fixed per-call
    cost."""

    def timed(n):
        sim.elapsed, sim.steps_done = 0.0, 0
        sim.run(n)
        return sim.elapsed

    n1, n2 = 1680, 5040
    timed(n1)
    t1 = min(timed(n1) for _ in range(2))
    t2 = min(timed(n2) for _ in range(2))
    return (t2 - t1) / (n2 - n1)


def in_turns(rates, prefix, fns, n, timer=event_ms):
    """Time each labelled fn by CUDA events (timer: event_ms or
    queued_ms) over n calls, in turns a, b, ..., ..., b, a; print every
    time in the order taken and return {label: best ms}."""
    order = list(fns) + list(reversed(fns))
    best = {}
    for label in order:
        ms = timer(fns[label], n)
        how = "queued behind a spin, in turns" if timer is queued_ms else "in turns"
        rates(f"{prefix}, {label} (CUDA events, {n} calls, {how})", ms * 1e-3)
        best[label] = min(best.get(label, ms), ms)
    return best


# (rows, stages) of the staged copy kernel that chip_smoke times beside the
# direct form; a pair the lattice's rows do not fit is skipped
COPY_STAGING = ((2, 4), (1, 4))


def copy_rate(rates, a, b, label, n=500):
    """The roofline's denominator: the port's copy kernel (ops/probes.py,
    csrc/lbm_probes.cu) moving the state a -> b, its direct form and one
    staged form, beside Tensor.copy_ (the library's copy), in turns. The
    copy moves the same bytes per site as a step of that storage. Raises
    unless every form leaves b == a. Returns {"ms": the best form's,
    "form": its name, "library_ms": Tensor.copy_'s, "forms": {name: ms}}."""
    from latticeboltzmann_tpu_torch.ops import probes

    fns = {"Tensor.copy_ (the library's copy)": lambda: b.copy_(a),
           "copy kernel, direct": lambda: probes.copy_state(a, b)}
    for rows, stages in COPY_STAGING:
        try:
            probes.copy_state(a, b, rows=rows, stages=stages)
        except ValueError:
            continue
        fns[f"copy kernel, staged rows={rows} stages={stages}"] = (
            lambda r=rows, st=stages: probes.copy_state(a, b, rows=r, stages=st))
        break
    for name, fn in fns.items():
        b.zero_()
        fn()
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} left dst != src")
    t = in_turns(rates, f"device copy of {label}", fns, n)
    library_ms = t.pop("Tensor.copy_ (the library's copy)")
    form = min(t, key=t.get)
    print(f"copy rate of {label}: the copy kernel's best form ({form}) {t[form] * 1e3!r} us, "
          f"the roofline's denominator; Tensor.copy_ {library_ms * 1e3!r} us beside it")
    return {"ms": t[form], "form": form, "library_ms": library_ms, "forms": t}


def share(label, kernel_ms, copy):
    """Print a kernel's share of the copy rate: the copy kernel's best time
    over the kernel's, with the library copy's beside it."""
    print(f"{label}: {copy['ms'] / kernel_ms!r} of the copy kernel's rate "
          f"({copy['library_ms'] / kernel_ms!r} of Tensor.copy_'s)")


class PhaseClock:
    """The wall time of each phase call of main(): done(label) closes the
    phase that ran since the last mark, run(label, fn, ...) times one
    call; each prints `phase <label> took S s` on its own line and keeps
    the seconds under its label (the phases' numbers)."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def done(self, label):
        now = time.perf_counter()
        self.seconds[label] = now - self._t
        print(f"phase {label} took {now - self._t:.1f} s")
        self._t = now

    def run(self, label, fn, *args, **kw):
        self._t = time.perf_counter()
        out = fn(*args, **kw)
        self.done(label)
        return out


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.bench import card_info
    from latticeboltzmann_tpu_torch.ops import cuda_build, fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import bytes_per_site

    clock_ = PhaseClock()
    card = card_info()
    print(f"card: {card}")
    # the sharded phases register their backends over meshes of their own;
    # the suite (phase 26) runs the registered defaults
    from latticeboltzmann_tpu_torch.models import engine
    default_backends = dict(engine._BACKENDS)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    clock_.done("1")

    # 2. build
    t0 = time.perf_counter()
    lib = cuda_build.build()
    cuda_build.load_library()
    print(f"build: {time.perf_counter() - t0:.3f} s -> {lib}")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "stack")):
            print(f"  ptxas: {line.strip()}")
    clock_.done("2")

    # 3. kernel vs its plain version
    rng = np.random.default_rng(SEED)
    max_err = {}
    for name, cfg, w in scenes(np.float32) + form_scenes(np.float32):
        f0 = perturbed_state(cfg, rng)
        worst(max_err, compare_kernel(name, cfg, w.astype(np.uint8), f0))
        worst(max_err, compare_kernel(name, cfg, None, f0))
    clock_.done("3")

    # 4. the main path, every launch counted, by variant and by form
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    # a Session's buffers are whole allocations: aligned
    form = fused_kernel.kernel_form(torch.float32, cfg.ny, ())
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda")
    sim.run(WARMUP)
    sim.elapsed, sim.steps_done = 0.0, 0
    sim.run(MAIN_STEPS)
    launches = expect_counts("main path", {"f32-spec": WARMUP + MAIN_STEPS}, form)["f32-spec"]
    f32_main = sim.state()
    re = sim.reynolds()
    if not (np.isfinite(f32_main).all() and (f32_main >= 0).all() and np.isfinite(re)):
        raise AssertionError(f"main path state not finite/non-negative, or Re {re!r}")
    print(f"main path: {MAIN_STEPS} steps (+{WARMUP} warmup) through backend=cuda, "
          f"wall spec {sim.wall_spec}, {launches} kernel launches of the {form} form, "
          f"Re {re!r}, {sim.mlups!r} MLUPS ({sim.elapsed!r} s)")
    runs = {}
    for backend in ("cuda", "torch"):
        runs[backend] = Simulation(cfg, walls, backend=backend, device="cuda").run(20).state()
    diff = np.abs(runs["cuda"] - runs["torch"])
    np.testing.assert_allclose(runs["cuda"], runs["torch"], rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    print(f"cuda vs torch backend after 20 steps: max |diff| {float(diff.max())!r} "
          f"(rtol {ENGINE_RTOL}, atol {ENGINE_ATOL})")
    narrow_launches, e = narrow_path(np.float32, "f32-spec", ENGINE_RTOL, ENGINE_ATOL, rng)
    worst(max_err, {"narrow": e})
    clock_.done("4")

    # 5. times at 800x4000
    rates = rates_printer(cfg, bytes_per_site(cfg.dtype))
    rates("kernel main path, spec variant (slope 1680/5040 steps)", slope(sim))
    dev = torch.device("cuda")
    a = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    b = torch.empty_like(a)
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    spec = sim.wall_spec
    # the roofline's denominator: the port's copy kernel on one state
    # buffer moves the same 72 B per site as a step
    copy = copy_rate(rates, a, b, "an 800x4000 float32 state")
    t = forms_in_turns(rates, "kernel launch", a, b, {"plane": solid, "spec": spec}, cfg, 500)
    for key, ms in t.items():
        share(f"f32 kernel, {key}", ms, copy)
    plain_ms = event_ms(lambda: fused_kernel.step_reference(a, solid, cfg), 20)
    rates("step_reference, its plain version (CUDA events, 20 steps)", plain_ms * 1e-3)
    wide_plain_ms = event_ms(lambda: fused_kernel.step_reference_wide(
        a, solid, cfg, fused_kernel.WIDE_COLUMNS[a.dtype]), 20)
    rates("step_reference_wide, the wide form's plain version (CUDA events, 20 steps)",
          wide_plain_ms * 1e-3)
    eng = Simulation(cfg, walls, backend="torch", device="cuda")
    eng.run(5)
    eng.elapsed, eng.steps_done = 0.0, 0
    eng.run(200)
    rates("plain torch engine (200 steps)", eng.elapsed / 200)
    # the spec variant: 9 f32 values read and 9 written per site
    f32_bound = bound(2 * a.numel() * a.element_size(), F32_OPS_PER_SITE * cfg.sites)
    f32_entries = [{
        "name": "lbm_stream_collide_wide<float, GEOM, 4> (plane, wall-free, spec): the wide "
                f"form, dispatched at 800x4000: {form == 'wide'}",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_wide_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1757",
        "launches": launches if form == "wide" else 0,
        "max_abs_err": max_err["wide"],
        "ms": t["wide form, spec"],
        "plain_ms": wide_plain_ms,
        "plane_ms": t["wide form, plane"],
        **f32_bound,
    }, {
        "name": "lbm_stream_collide<float> (plane, wall-free, spec): the narrow form "
                f"(launches: the 800x{NARROW_NY} path; ms at 800x4000)",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1757",
        "launches": narrow_launches + (launches if form == "narrow" else 0),
        "max_abs_err": max_err["narrow"],
        "ms": t["narrow form, spec"],
        "plain_ms": plain_ms,
        "plane_ms": t["narrow form, plane"],
        **f32_bound,
    }]
    del sim, eng, a, b
    clock_.done("5")

    ds, ds_counts, clock, ds_main = clock_.run("6-8", ds_phases, copy)
    bf16_main, options = clock_.run("9-14", option_phases, f32_main)
    ext = clock_.run("15-17+22-24", sharded_phases, f32_main, ds_counts, clock)
    anatomy = clock_.run("18-20", anatomy_phases)
    clock_.run("21", panels_phase)
    clock_.run("25", probed_phases, f32_main)
    engine._BACKENDS.update(default_backends)
    clock_.run("26", suite_phase, card)
    clock_.run("27", validate_ds_phase)
    # phase 28 writes under build/ of the checkout, which git ignores
    scratch = cuda_build.build_dir().parent.parent
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_", dir=scratch) as tmp:
        cli_launches = clock_.run("28", cli_phase, pathlib.Path(tmp))
    temporal = clock_.run("29", temporal_phases, f32_main, bf16_main)
    ds_temporal = clock_.run("30", ds_temporal_phase, ds_main, ds_counts, clock, copy)
    ds_ext_temporal = clock_.run("31", ds_sharded_temporal_phase, ds_counts, clock, copy)

    entries = [*f32_entries, *options, ds, ds_temporal, ds_ext_temporal, *ext, *anatomy, temporal]
    add_cli_launches(entries, cli_launches, torch.cuda.device_count())
    print(f"phase seconds (wall, by phase call; {sum(clock_.seconds.values()):.1f} s in all): "
          + json.dumps({k: round(v, 1) for k, v in clock_.seconds.items()}))
    print("bounds computed from this run's inputs, by kernel (not measured; not in the kernels "
          "line): " + json.dumps([{"name": e["name"], **computed_bounds(e)} for e in entries]))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def scenes(dtype):
    """The four comparison scenes of phases 3, 6 and 9: (name, cfg,
    walls)."""
    from latticeboltzmann_tpu_torch import LatticeConfig, geometry

    out = []
    w = geometry.channel(16, 40)
    w[5:9, 10:13] = True
    out.append(("16x40 channel+barrier", LatticeConfig(nx=16, ny=40, dtype=dtype), w))
    w = geometry.channel(24, 40)
    w[8:14, 0:3] = True
    out.append(("24x40 walls on columns 0-2",
                LatticeConfig(nx=24, ny=40, dtype=dtype, accel=0.005), w))
    out.append(("16x40 empty box", LatticeConfig(nx=16, ny=40, dtype=dtype),
                geometry.empty(16, 40)))
    out.append(("800x4000 reference_barrier", LatticeConfig(nx=800, ny=4000, dtype=dtype),
                geometry.reference_barrier(800, 4000)))
    return out


def form_scenes(dtype):
    """Two more scenes for the two forms of the single-chip kernel: one a
    single thread of the wide form wide (NY == its column count for this
    storage type, so the thread is its own left and right neighbour and
    forces both ways), and 24x37, which only the narrow form takes."""
    from latticeboltzmann_tpu_torch import LatticeConfig, geometry
    from latticeboltzmann_tpu_torch.ops import fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import storage_dtype

    v = fused_kernel.WIDE_COLUMNS[storage_dtype(dtype)]
    w = geometry.channel(24, 37)
    w[8:14, 0:3] = True
    return [(f"8x{v} channel (NY == V)", LatticeConfig(nx=8, ny=v, dtype=dtype, accel=0.005),
             geometry.channel(8, v)),
            ("24x37 walls on columns 0-2 (NY % V != 0)",
             LatticeConfig(nx=24, ny=37, dtype=dtype, accel=0.005), w)]


def narrow_path(dtype, variant, rtol, atol, rng):
    """The narrow form's path on the reference scene at 800 x NARROW_NY, an
    NY the wide form does not take (full tiles, then a partial one, in
    every row): the kernel bitwise against step_reference at that shape,
    spec and plane variants, then Simulation(backend="cuda") for
    NARROW_STEPS counted launches of the narrow form; finite, non-negative,
    and a 20-step run within (rtol, atol) of the "torch" backend. Returns
    the launches and the kernel's max |diff| at that shape."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry

    cfg = LatticeConfig(nx=800, ny=NARROW_NY, dtype=dtype)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    f0 = perturbed_state(cfg, rng)
    err = {}
    for geom in (geometry.infer_spec(walls), walls.astype(np.uint8)):
        worst(err, compare_kernel(f"800x{NARROW_NY} reference_barrier", cfg, geom, f0))
    if set(err) != {"narrow"}:
        raise AssertionError(f"800x{NARROW_NY}: forms {sorted(err)} ran, expected the narrow only")
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda")
    sim.run(NARROW_STEPS)
    n = expect_counts(f"narrow path ({variant})", {variant: NARROW_STEPS}, "narrow")[variant]
    f = sim.state()
    re = sim.reynolds()
    if not (np.isfinite(f).all() and (f >= 0).all() and np.isfinite(re)):
        raise AssertionError(f"narrow path ({variant}) state not finite/non-negative, or Re {re!r}")
    runs = [Simulation(cfg, walls, backend=b, device="cuda").run(20).state()
            for b in ("cuda", "torch")]
    np.testing.assert_allclose(runs[0], runs[1], rtol=rtol, atol=atol)
    print(f"narrow path: {NARROW_STEPS} steps through backend=cuda at 800x{NARROW_NY}, {n} "
          f"{variant} launches of the narrow form, Re {re!r}, {sim.mlups!r} MLUPS; vs the "
          f"torch backend after 20 steps: max |diff| {float(np.abs(runs[0] - runs[1]).max())!r}")
    return n, err["narrow"]


def forms_in_turns(rates, prefix, a, b, geoms, cfg, n, **kw):
    """Time one launch a -> b of both forms of the single-chip kernel for
    each labelled geometry, in turns; {"<form> form, <label>": best ms}."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel

    return in_turns(rates, prefix, {
        f"{form} form, {label}": (lambda form=form, g=g: fused_kernel.step(a, b, g, cfg,
                                                                           form=form, **kw))
        for label, g in geoms.items() for form in fused_kernel.FORMS}, n)


def ds_passes(n_steps):
    """The temporal form's passes of a ds session's advance(n_steps):
    n_steps // DS_TEMPORAL of DS_TEMPORAL steps and one of the rest."""
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel

    return -(-n_steps // fused_ds_kernel.DS_TEMPORAL)


def ds_phases(copy):
    """Phases 6-8: the pair-DP kernel and path. copy: copy_rate's result
    for one float32 state (a ds step moves two). Returns the one-step ds
    kernel's entry of the kernels line, ds_site_counts(), the SM clock
    (MHz) read under load, and the ds main path's {"launches": passes of
    the temporal form, "state": its pair after WARMUP + MAIN_STEPS steps,
    "us_per_step": its slope}."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.models.engine import initial_state
    from latticeboltzmann_tpu_torch.ops import df64, fused_ds_kernel

    # 6. the ds kernel vs its plain version, both tiers and both variants
    rng = np.random.default_rng(SEED)
    max_err = {False: 0.0, True: 0.0}
    for name, cfg, w in scenes(np.float64):
        f = initial_state(cfg)
        f0 = f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))
        for exact in (False, True):
            max_err[exact] = max(max_err[exact], compare_ds_kernel(name, cfg, w, f0, exact))
    big = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    for name, w in (("800x4000 reference_barrier", geometry.reference_barrier(big.nx, big.ny)),
                    ("800x4000 symmetric channel", geometry.channel(big.nx, big.ny)),
                    ("800x4000 empty box", geometry.empty(big.nx, big.ny))):
        for exact in (False, True):
            long_ds_check(name, big, w, exact)

    # 7. the ds main path: passes of DS_TEMPORAL steps through the temporal
    # form, every launch and step counted; then the one-step form's path
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda-ds64")
    sim.run(WARMUP)
    sim.elapsed, sim.steps_done = 0.0, 0
    sim.run(MAIN_STEPS)
    passes = ds_passes(WARMUP) + ds_passes(MAIN_STEPS)
    launches = expect_counts("ds main path", {"ds-temporal": passes})["ds-temporal"]
    if fused_ds_kernel.TEMPORAL_STEPS != WARMUP + MAIN_STEPS:
        raise AssertionError(f"ds main path: {fused_ds_kernel.TEMPORAL_STEPS} steps counted in "
                             f"the temporal form's passes, expected {WARMUP + MAIN_STEPS}")
    sess = sim._session
    f = sim.state()
    re = sim.reynolds()
    if not (f.dtype == np.float64 and np.isfinite(f).all() and (f >= 0).all()
            and np.isfinite(re)):
        raise AssertionError(f"ds main path state not finite/non-negative, or Re {re!r}")
    print(f"ds main path: {MAIN_STEPS} steps (+{WARMUP} warmup) through backend=cuda-ds64, "
          f"{launches} counted passes of {sess.temporal} steps of the temporal form "
          f"(lbm_ds_temporal_steps), no one-step launch, Re {re!r}, "
          f"{sim.mlups!r} MLUPS ({sim.elapsed!r} s)")
    main = {"launches": launches, "state": sim.f}
    cfg_n = LatticeConfig(nx=800, ny=NARROW_NY, dtype=np.float64)
    reset_counts()
    sim_n = Simulation(cfg_n, geometry.reference_barrier(cfg_n.nx, cfg_n.ny), backend="cuda-ds64")
    sim_n.run(NARROW_STEPS)
    step_launches = expect_counts(f"ds path at 800x{NARROW_NY}", {"ds": NARROW_STEPS})["ds"]
    f_n, re_n = sim_n.state(), sim_n.reynolds()
    if not (np.isfinite(f_n).all() and (f_n >= 0).all() and np.isfinite(re_n)):
        raise AssertionError(f"ds path at 800x{NARROW_NY}: state not finite/non-negative, or Re "
                             f"{re_n!r}")
    print(f"ds path at 800x{NARROW_NY} (NY no multiple of {fused_ds_kernel.TEMPORAL_COLUMNS}: "
          f"one step a launch): {NARROW_STEPS} steps through backend=cuda-ds64, "
          f"{step_launches} counted one-step launches (lbm_stream_collide_ds), Re {re_n!r}, "
          f"{sim_n.mlups!r} MLUPS")
    del sim_n, f_n
    got = Simulation(cfg, walls, backend="cuda-ds64").run(DS_COMPARE_STEPS).state()
    want = Simulation(cfg, walls, backend="torch", device="cuda").run(DS_COMPARE_STEPS).state()
    rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())
    if not rel < DS_RTOL:
        raise AssertionError(f"cuda-ds64 vs float64 torch after {DS_COMPARE_STEPS} steps: "
                             f"max rel {rel!r} >= {DS_RTOL}")
    print(f"cuda-ds64 vs float64 torch backend after {DS_COMPARE_STEPS} steps from rest: "
          f"max rel {rel!r} (bar {DS_RTOL})")

    # 8. times at 800x4000
    rates = rates_printer(cfg, fused_ds_kernel.BYTES_PER_SITE_DS)
    main["us_per_step"] = slope(sim) * 1e6
    rates(f"ds main path, fast tier, passes of {sess.temporal} (slope 1680/5040 steps)",
          main["us_per_step"] * 1e-6)

    dev = torch.device("cuda")
    f = initial_state(cfg)
    a = df64.from_f64(f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape)), dev)
    b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    ms, plain = {}, {}
    for exact in (False, True):
        tier = "exact" if exact else "fast"
        ms[exact] = event_ms(lambda: fused_ds_kernel.step(
            a, b, solid, cfg, has_walls=True, exact=exact), 200)
        plain[exact] = event_ms(lambda: fused_ds_kernel.step_reference(
            a.hi, a.lo, solid, cfg, exact), 3)
        rates(f"ds kernel launch, {tier} tier (CUDA events, 200 launches)", ms[exact] * 1e-3)
        rates(f"ds step_reference, {tier} tier, its plain version (CUDA events, 3 steps)",
              plain[exact] * 1e-3)
    for exact in (False, True):
        # a ds step reads and writes both pair components: two float32 copies
        share(f"ds kernel, {'exact' if exact else 'fast'} tier", ms[exact],
              {k: 2 * copy[k] for k in ("ms", "library_ms")})
    eng = Simulation(cfg, walls, backend="torch-ds64", device="cuda")
    eng.run(1)
    eng.elapsed, eng.steps_done = 0.0, 0
    eng.run(3)
    rates("eager torch-ds64 engine, exact tier (3 steps)", eng.elapsed / 3)
    counts = ds_site_counts()
    clock = sm_clock_mhz(lambda: fused_ds_kernel.step(a, b, solid, cfg, has_walls=True), 2000)
    # both pair components read and written, and the mask byte
    n_bytes = 4 * a.hi.numel() * 4 + solid.numel()
    bounds = {exact: counted_bound(n_bytes, counts[("ds", True, exact)], cfg.sites, clock)
              for exact in (False, True)}
    for exact, bd in bounds.items():
        print(f"ds kernel, {'exact' if exact else 'fast'} tier, masked: bound "
              f"{bd['bound_ms'] * 1e3!r} us by {bd['bound_by']} ({bd['ops_per_site']} ops a site "
              f"at {PEAK_F32_OPS_PER_S:.3g}/s, {n_bytes} B at {PEAK_BYTES_PER_S:.3g} B/s); issue "
              f"floor {bd['issue_floor_ms'] * 1e3!r} us ({bd['fp32_instructions_per_site']} FP32 "
              f"instructions a site at {clock!r} MHz); kernel {ms[exact] * 1e3!r} us")
    exact_keys = {f"exact_tier_{k}": v for k, v in bounds[True].items() if k != "library_ms"}
    return {
        "name": "lbm_stream_collide_ds (one step a launch: temporal=1, and the shapes the "
                f"temporal form does not take; launches: the 800x{NARROW_NY} path)",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_ds_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_ds_kernel.py:272 (temporal=1)",
        "launches": step_launches,
        "max_abs_err": max(max_err.values()),
        "ms": ms[False],
        "plain_ms": plain[False],
        "exact_tier_ms": ms[True],
        "exact_tier_plain_ms": plain[True],
        # the fast tier, masked; the exact tier's beside it
        **bounds[False],
        **exact_keys,
    }, counts, clock, main


def slip_scene(nx, ny):
    """A channel whose top wall row is slip_x, with a slip_y block:
    (walls, slip_x, slip_y)."""
    from latticeboltzmann_tpu_torch import geometry

    walls = geometry.channel(nx, ny)
    slip_x = np.zeros_like(walls)
    slip_x[0] = True
    walls[0] = False
    slip_y = np.zeros_like(walls)
    slip_y[nx // 3: nx // 3 + max(nx // 20, 2), ny // 8: ny // 8 + max(ny // 200, 2)] = True
    return walls, slip_x, slip_y


def option_phases(f32_main):
    """Phases 9-14: bf16 storage, the spec variant, slip codes and fast
    math. f32_main: the float32 main path's state after WARMUP +
    MAIN_STEPS steps (phase 4). Returns the bf16 main path's state after
    as many steps (phase 13) and the kernels line's entries for the bf16,
    slip and fast-math variant families."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry, initial_state
    from latticeboltzmann_tpu_torch.ops import fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import bytes_per_site, state_tensor

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    bf16 = "bfloat16"

    # 9. bf16 storage against its plain version, plane and wall-free
    bf16_err = {}
    for name, cfg, w in scenes(bf16) + form_scenes(bf16):
        f0 = perturbed_state(cfg, rng)
        worst(bf16_err, compare_kernel(name, cfg, w.astype(np.uint8), f0))
        worst(bf16_err, compare_kernel(name, cfg, None, f0))

    # 10. the spec variant against the plane variant and step_reference
    spec_err = {}
    for dtype in (np.float32, bf16):
        cfg = LatticeConfig(nx=800, ny=4000, dtype=dtype)
        for name, w in (("reference_barrier", geometry.reference_barrier(800, 4000)),
                        ("cylinder", geometry.channel_with_cylinder(800, 4000)),
                        ("channel", geometry.channel(800, 4000))):
            spec = geometry.infer_spec(w)
            if spec is None:
                raise AssertionError(f"{name}: infer_spec found no closed form")
            f0 = perturbed_state(cfg, rng)
            err = compare_kernel(f"800x4000 {name} {spec}", cfg, spec, f0)
            worst(bf16_err if dtype == bf16 else spec_err, err)
            a = state_tensor(f0, cfg.dtype, dev)
            b, c = torch.empty_like(a), torch.empty_like(a)
            plane = torch.as_tensor(w.astype(np.uint8), device=dev)
            for _ in range(10):
                for form in fused_kernel.FORMS:
                    fused_kernel.step(a, b, spec, cfg, form=form)
                    fused_kernel.step(a, c, plane, cfg, form=form)
                    if not torch.equal(b, c):
                        raise AssertionError(f"{name} ({a.dtype}), {form} form: spec variant "
                                             "!= plane variant")
                a, b = b, a
            print(f"spec variant == plane variant in both forms, 800x4000 {name} ({a.dtype}), "
                  f"10 steps")

    # 11. slip codes, bitwise, then the slip path through the facade
    slip_err = {}
    for nx, ny in ((24, 40), (24, 37), (800, 4000)):
        walls, slip_x, slip_y = slip_scene(nx, ny)
        cls = fused_kernel.class_plane(walls, slip_x, slip_y)
        for dtype in (np.float32, bf16):
            cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
            worst(slip_err, compare_kernel(
                f"{nx}x{ny} slip_x top row + slip_y block", cfg, cls,
                perturbed_state(cfg, rng)))
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    form = fused_kernel.kernel_form(torch.float32, cfg.ny, ())
    walls, slip_x, slip_y = slip_scene(800, 4000)
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda", slip_x=slip_x, slip_y=slip_y)
    sim.run(OPTION_STEPS)
    slip_launches = expect_counts("slip path", {"f32-plane-slip": OPTION_STEPS},
                                  form)["f32-plane-slip"]
    f = sim.state()
    if not (np.isfinite(f).all() and (f >= 0).all() and np.isfinite(sim.reynolds())):
        raise AssertionError("slip path state not finite/non-negative")
    print(f"slip path: {OPTION_STEPS} steps through Simulation(slip_x=, slip_y=, "
          f"backend=cuda), {slip_launches} launches, Re {sim.reynolds()!r}")
    runs = {}
    for backend in ("cuda", "torch"):
        runs[backend] = Simulation(cfg, walls, backend=backend, device="cuda", slip_x=slip_x,
                                   slip_y=slip_y).run(20).state()
    np.testing.assert_allclose(runs["cuda"], runs["torch"], rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    print(f"cuda vs torch backend with slip after 20 steps: max |diff| "
          f"{float(np.abs(runs['cuda'] - runs['torch']).max())!r}")

    # 12. fast math within its stated tolerance, then its facade path
    walls = geometry.reference_barrier(800, 4000)
    spec = geometry.infer_spec(walls)
    start = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    steps, bar = fused_kernel.FAST_MATH_STEPS, fused_kernel.FAST_MATH_RTOL
    ref = start
    for _ in range(steps):
        ref = fused_kernel.step_reference(ref, None, cfg, wall_spec=spec, fast_math=True)
    fast_abs = fast_rel = 0.0
    ends = {}
    for fast_form in fused_kernel.FORMS:
        a, b = start.clone(), torch.empty_like(start)
        for _ in range(steps):
            fused_kernel.step(a, b, spec, cfg, fast_math=True, form=fast_form)
            a, b = b, a
        ends[fast_form] = a
        abs_, rel = float((a - ref).abs().max()), float(((a - ref).abs() / ref.abs()).max())
        if not rel <= bar:
            raise AssertionError(f"fast math, {fast_form} form, after {steps} steps: max rel "
                                 f"{rel!r} > {bar}")
        print(f"fast-math kernel, {fast_form} form, vs step_reference (IEEE 1/rho) after {steps} "
              f"chained steps: max rel {rel!r} (bar {bar}), max |diff| {abs_!r}, "
              f"{int((a != ref).sum())} of {a.numel()} values differ")
        fast_abs, fast_rel = max(fast_abs, abs_), max(fast_rel, rel)
    if not torch.equal(ends["wide"], ends["narrow"]):
        raise AssertionError(f"fast math: the wide form's state != the narrow form's after "
                             f"{steps} steps")
    print(f"fast math: the wide form's state == the narrow form's after {steps} steps")
    del ends, start
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda", fast_math=True)
    sim.run(OPTION_STEPS)
    fast_launches = expect_counts("fast-math path", {"f32-spec-fast": OPTION_STEPS},
                                  form)["f32-spec-fast"]
    f = sim.state()
    if not (np.isfinite(f).all() and (f >= 0).all()):
        raise AssertionError("fast-math path state not finite/non-negative")
    print(f"fast-math path: {OPTION_STEPS} steps through Simulation(fast_math=True, "
          f"backend=cuda), {fast_launches} launches, Re {sim.reynolds()!r}")

    # 13. the bf16 main path, every launch counted
    cfg16 = LatticeConfig(nx=800, ny=4000, dtype=bf16)
    form16 = fused_kernel.kernel_form(torch.bfloat16, cfg16.ny, ())
    reset_counts()
    sim = Simulation(cfg16, walls, backend="cuda")
    sim.run(WARMUP)
    sim.elapsed, sim.steps_done = 0.0, 0
    sim.run(MAIN_STEPS)
    bf16_launches = expect_counts("bf16 main path", {"bf16-spec": WARMUP + MAIN_STEPS},
                                  form16)["bf16-spec"]
    f = bf16_main = sim.state()
    re = sim.reynolds()
    if not (f.dtype == np.float32 and np.isfinite(f).all() and (f >= 0).all()
            and np.isfinite(re)):
        raise AssertionError(f"bf16 main path state not finite/non-negative, or Re {re!r}")
    excess = np.abs(f - f32_main) - (BF16_ATOL + BF16_RTOL * np.abs(f32_main))
    print(f"bf16 main path: {MAIN_STEPS} steps (+{WARMUP} warmup) through backend=cuda, "
          f"{bf16_launches} kernel launches of the {form16} form, Re {re!r}, {sim.mlups!r} MLUPS "
          f"({sim.elapsed!r} s); vs the float32 main path: max |diff| "
          f"{float(np.abs(f - f32_main).max())!r}, worst margin to the bar "
          f"{float(excess.max())!r} (rtol {BF16_RTOL}, atol {BF16_ATOL})")
    np.testing.assert_allclose(f, f32_main, rtol=BF16_RTOL, atol=BF16_ATOL)
    runs = {}
    for backend in ("cuda", "torch"):
        runs[backend] = Simulation(cfg16, walls, backend=backend, device="cuda").run(20).state()
    np.testing.assert_allclose(runs["cuda"], runs["torch"], rtol=BF16_RTOL, atol=BF16_ATOL)
    print(f"bf16 cuda vs bf16 torch backend after 20 steps: max |diff| "
          f"{float(np.abs(runs['cuda'] - runs['torch']).max())!r}, "
          f"{int((runs['cuda'] != runs['torch']).sum())} values differ")
    bf16_narrow_launches, e = narrow_path(bf16, "bf16-spec", BF16_RTOL, BF16_ATOL, rng)
    worst(bf16_err, {"narrow": e})

    # 14. times
    rates16 = rates_printer(cfg16, bytes_per_site(bf16))
    rates16("bf16 main path, spec variant (slope 1680/5040 steps)", slope(sim))
    del sim
    a = state_tensor(perturbed_state(cfg16, rng), bf16, dev)
    b = torch.empty_like(a)
    plane = torch.as_tensor(walls.astype(np.uint8), device=dev)
    copy16 = copy_rate(rates16, a, b, "an 800x4000 bf16 state")
    t16 = forms_in_turns(rates16, "bf16 kernel", a, b, {"plane": plane, "spec": spec}, cfg16, 500)
    for key, ms in t16.items():
        share(f"bf16 kernel, {key}", ms, copy16)
    bf16_plain_ms = event_ms(lambda: fused_kernel.step_reference(a, None, cfg16,
                                                                 wall_spec=spec), 20)
    rates16("bf16 step_reference, its plain version (CUDA events, 20 steps)",
            bf16_plain_ms * 1e-3)
    bf16_wide_plain_ms = event_ms(lambda: fused_kernel.step_reference_wide(
        a, None, cfg16, fused_kernel.WIDE_COLUMNS[a.dtype], wall_spec=spec), 20)
    rates16("bf16 step_reference_wide, the wide form's plain version (CUDA events, 20 steps)",
            bf16_wide_plain_ms * 1e-3)
    del a, b

    big = LatticeConfig(nx=4000, ny=16000, dtype=bf16)
    big_spec = geometry.infer_spec(geometry.reference_barrier(4000, 16000))
    # the rest state: a timing input (the kernel's branches do not
    # depend on the values), made without 9 GB of host noise
    a = state_tensor(initial_state(big), bf16, dev)
    b = torch.empty_like(a)
    rates_big = rates_printer(big, bytes_per_site(bf16))
    big_ms = forms_in_turns(rates_big, "bf16 kernel, 4000x16000", a, b, {"spec": big_spec}, big, 50)
    copy_big = copy_rate(rates_big, a, b, "a 4000x16000 bf16 state", n=50)
    for key, ms in big_ms.items():
        share(f"bf16 kernel, 4000x16000, {key}", ms, copy_big)
    del a, b

    rates = rates_printer(cfg, bytes_per_site(np.float32))
    a = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    b = torch.empty_like(a)
    walls_s, slip_x, slip_y = slip_scene(800, 4000)
    cls = torch.as_tensor(fused_kernel.class_plane(walls_s, slip_x, slip_y), device=dev)
    t = forms_in_turns(rates, "f32 kernel", a, b, {"spec": spec, "plane with slip codes": cls},
                       cfg, 500)
    t.update(forms_in_turns(rates, "f32 kernel, fast math", a, b, {"spec, fast math": spec}, cfg,
                            500, fast_math=True))
    slip_plain_ms = event_ms(lambda: fused_kernel.step_reference(a, cls, cfg), 20)
    fast_plain_ms = event_ms(lambda: fused_kernel.step_reference(
        a, None, cfg, wall_spec=spec, fast_math=True), 20)
    rates("step_reference with slip codes (CUDA events, 20 steps)", slip_plain_ms * 1e-3)
    rates("step_reference, spec, IEEE 1/rho (CUDA events, 20 steps)", fast_plain_ms * 1e-3)

    sources = {"wide": "latticeboltzmann_tpu_torch/csrc/lbm_wide_step.cu",
               "narrow": "latticeboltzmann_tpu_torch/csrc/lbm_step.cu"}
    replaces = "latticeboltzmann_tpu/ops/fused_kernel.py:1757"
    n_f = 9 * cfg.sites  # f values of one state at 800x4000
    ops = F32_OPS_PER_SITE * cfg.sites
    other = {"wide": "narrow", "narrow": "wide"}
    return bf16_main, [
        {"name": "lbm_stream_collide_wide<__nv_bfloat16, GEOM, 8> (plane, wall-free, spec): the "
                 f"wide form, dispatched at 800x4000: {form16 == 'wide'}",
         "route": "cuda", "source": sources["wide"], "replaces": replaces,
         "launches": bf16_launches if form16 == "wide" else 0,
         "max_abs_err": bf16_err["wide"], "ms": t16["wide form, spec"],
         "plain_ms": bf16_wide_plain_ms, "plane_ms": t16["wide form, plane"],
         "ms_4000x16000": big_ms["wide form, spec"], **bound(2 * n_f * 2, ops)},
        {"name": "lbm_stream_collide<__nv_bfloat16> (plane, wall-free, spec): the narrow form "
                 f"(launches: the 800x{NARROW_NY} path; ms at 800x4000)",
         "route": "cuda", "source": sources["narrow"], "replaces": replaces,
         "launches": bf16_narrow_launches + (bf16_launches if form16 == "narrow" else 0),
         "max_abs_err": bf16_err["narrow"], "ms": t16["narrow form, spec"],
         "plain_ms": bf16_plain_ms, "plane_ms": t16["narrow form, plane"],
         "ms_4000x16000": big_ms["narrow form, spec"], **bound(2 * n_f * 2, ops)},
        {"name": f"the {form} form of the float32 plane variant with slip codes 2/3 "
                 "(lbm_stream_collide_wide<float, plane, 4> or lbm_stream_collide<float, plane>)",
         "route": "cuda", "source": sources[form], "replaces": replaces,
         "launches": slip_launches, "max_abs_err": max(slip_err.values()),
         "ms": t[f"{form} form, plane with slip codes"], "plain_ms": slip_plain_ms,
         f"{other[form]}_form_ms": t[f"{other[form]} form, plane with slip codes"],
         **bound(2 * n_f * 4 + cls.numel(), ops)},
        {"name": f"the {form} form of the float32 spec variant with fast math (rcp.approx.f32; "
                 "lbm_stream_collide_wide<float, spec, 4> or lbm_stream_collide<float, spec>)",
         "route": "cuda", "source": sources[form], "replaces": replaces,
         "launches": fast_launches, "max_abs_err": fast_abs, "max_rel_err": fast_rel,
         "ms": t[f"{form} form, spec, fast math"], "plain_ms": fast_plain_ms,
         f"{other[form]}_form_ms": t[f"{other[form]} form, spec, fast math"],
         "spec_variant_max_abs_err": max(spec_err.values()), **bound(2 * n_f * 4, ops)},
    ]


def guard_off_at_boundaries(f, nx):
    """A copy of the state f with the forcing guard failing (f6 below its
    decrement) at column 0 of the last row of the 4-shard mesh's first
    shard and of the first row of its third, which is also the 2-shard
    mesh's boundary: an edge row's forcing then depends on its halo row's
    own guard."""
    f = f.copy()
    f[6, [nx // 4 - 1, nx // 2], 0] = 1e-6
    return f


def ring_halos(shards):
    """Each shard's (top, bot) halo rows, all 9 planes of its ring
    neighbours' boundary rows, as contiguous (9, NY) tensors."""
    n = len(shards)
    return [(shards[(k - 1) % n][:, -1].contiguous(), shards[(k + 1) % n][:, 0].contiguous())
            for k in range(n)]


def shard_planes(plane, n):
    """A class plane on the card as each of n shards' ShardPlane."""
    from latticeboltzmann_tpu_torch.ops.fused_kernel import ShardPlane

    nx = plane.shape[0]
    L = nx // n
    return [ShardPlane(plane[k * L:(k + 1) * L].contiguous(), plane[(k * L - 1) % nx].contiguous(),
                       plane[(k * L + L) % nx].contiguous()) for k in range(n)]


def ext_calls(launcher, L, src, dst, halo, geom, **kw):
    """One shard's ext-halo launches of one step: the interior rows
    [1, L-1) without halos, then rows 0 and L-1 (one launch for a shard
    of fewer than 3 rows)."""
    if L < 3:
        return [launcher(src, dst, halo, geom, row0=0, rows=L, **kw)]
    return [launcher(src, dst, None, geom, row0=1, rows=L - 2, **kw),
            *(launcher(src, dst, halo, geom, row0=r, rows=1, **kw) for r in (0, L - 1))]


def compare_ext(name, cfg, geom, f0, n, steps=10, fast_math=False):
    """`steps` steps of the ext-halo stream-collide kernel over n virtual
    shards of the card, both forms (wide, narrow) launched from the same
    input each step, each shard held against step_reference_ext
    (bitwise, unless fast_math), and so each form against the other; the
    wide form also against its plain version step_reference_ext_wide.
    geom: None, a host class plane, or a wall spec. Returns (joined state,
    {form: max |diff|})."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import state_tensor

    dev = torch.device("cuda")
    L = cfg.nx // n
    plane = isinstance(geom, np.ndarray)
    geoms = shard_planes(torch.as_tensor(geom, device=dev), n) if plane else [geom] * n
    f = state_tensor(f0, cfg.dtype, dev)
    err = dict.fromkeys(fused_kernel.FORMS, 0.0)
    for _ in range(steps):
        shards = [f[:, k * L:(k + 1) * L].contiguous() for k in range(n)]
        halos = ring_halos(shards)
        outs = {form: [] for form in fused_kernel.FORMS}
        for k in range(n):
            ref = fused_kernel.step_reference_ext(shards[k], halos[k], geoms[k], cfg,
                                                  row_offset=k * L)
            if not fast_math:
                wide_ref = fused_kernel.step_reference_ext_wide(
                    shards[k], halos[k], geoms[k], cfg, fused_kernel.WIDE_COLUMNS[ref.dtype],
                    row_offset=k * L)
                if not torch.equal(wide_ref, ref):
                    raise AssertionError(f"{name}: step_reference_ext_wide != step_reference_ext "
                                         f"on shard {k} of {n}")
            for form in fused_kernel.FORMS:
                dst = torch.full_like(shards[k], float("nan"))
                for call in ext_calls(fused_kernel.ext_launcher, L, shards[k], dst, halos[k],
                                      geoms[k], cfg=cfg, row_offset=k * L, fast_math=fast_math,
                                      form=form):
                    call()
                d = (dst.float() - ref.float()).abs()
                e = float(d.max())
                if not fast_math and not (torch.equal(dst, ref) and e <= KERNEL_ATOL):
                    bad = torch.nonzero(dst != ref)
                    raise AssertionError(
                        f"{name}: ext-halo kernel ({form} form) != step_reference_ext on shard "
                        f"{k} of {n}, max |diff| {e!r} at {bad.shape[0]} values (first "
                        f"{bad[:5].tolist()})")
                err[form] = max(err[form], e)
                outs[form].append(dst)
            if not torch.equal(outs["wide"][k], outs["narrow"][k]):
                raise AssertionError(f"{name}: the ext-halo kernel's wide form != its narrow "
                                     f"form on shard {k} of {n}")
        f = torch.cat(outs["wide"], dim=1)
    torch.cuda.synchronize()
    kind = "wall-free" if geom is None else ("plane" if plane else "spec")
    print(f"ext-halo kernel vs step_reference_ext {name} ({f.dtype}, {kind}, "
          f"fast math {fast_math}), {n} virtual shards, {steps} steps, forms wide == narrow"
          f"{'' if fast_math else ' == step_reference_ext_wide'}: max |diff| = "
          f"{max(err.values())!r}")
    return f, err


def compare_ds_ext(name, cfg, walls, f0, n, exact, steps=10):
    """The same for the ext-halo ds kernel: the masked variant when walls
    has a solid site, else the wall-free one; bitwise. Returns max
    |diff| over both pair components."""
    from latticeboltzmann_tpu_torch.ops import df64, fused_ds_kernel

    dev = torch.device("cuda")
    L = cfg.nx // n
    has_walls = bool(walls.any())
    planes = shard_planes(torch.as_tensor(walls.astype(np.uint8), device=dev), n)
    a = df64.from_f64(f0, dev)
    err = 0.0
    for _ in range(steps):
        shards = [df64.DS(a.hi[:, k * L:(k + 1) * L].contiguous(),
                          a.lo[:, k * L:(k + 1) * L].contiguous()) for k in range(n)]
        his, los = ring_halos([s.hi for s in shards]), ring_halos([s.lo for s in shards])
        outs = []
        for k in range(n):
            halo = tuple(df64.DS(h, lo) for h, lo in zip(his[k], los[k]))
            dst = df64.DS(torch.full_like(shards[k].hi, float("nan")),
                          torch.full_like(shards[k].lo, float("nan")))
            for call in ext_calls(fused_ds_kernel.ext_launcher, L, shards[k], dst, halo,
                                  planes[k], cfg=cfg, has_walls=has_walls, exact=exact):
                call()
            ref = fused_ds_kernel.step_reference_ext(shards[k].hi, shards[k].lo, halo,
                                                     planes[k] if has_walls else None, cfg, exact)
            d = torch.maximum((dst.hi - ref.hi).abs(), (dst.lo - ref.lo).abs())
            e = float(d.max())
            if not (torch.equal(dst.hi, ref.hi) and torch.equal(dst.lo, ref.lo)):
                raise AssertionError(
                    f"{name}: ext-halo ds kernel ({'exact' if exact else 'fast'}) != "
                    f"step_reference_ext on shard {k} of {n}, max |diff| {e!r}")
            err = max(err, e)
            outs.append(dst)
        a = df64.DS(torch.cat([o.hi for o in outs], 1), torch.cat([o.lo for o in outs], 1))
    torch.cuda.synchronize()
    print(f"ext-halo ds kernel vs step_reference_ext {name} ({'exact' if exact else 'fast'} "
          f"tier, {'masked' if has_walls else 'wall-free'}), {n} virtual shards, {steps} steps: "
          f"max |diff| = {err!r}")
    return err


# bound of an edge row's wait in the checks below, seconds: far above a
# step's time, far below the run's
RDMA_CHECK_TIMEOUT_S = 1.0


class RdmaRing:
    """n virtual shards of the card wired for the rdma kernel as the
    sharded session wires them: two buffers per shard that swap roles, an
    RdmaEnd and a stream per shard, one launch per shard and buffer
    parity. step() launches the next step of every shard (or of `only`)."""

    def __init__(self, cfg, geom, f0, n, fast_math=False, timeout_s=RDMA_CHECK_TIMEOUT_S,
                 form=None):
        from latticeboltzmann_tpu_torch.ops import fused_kernel
        from latticeboltzmann_tpu_torch.utils.interop import state_tensor

        dev = torch.device("cuda", torch.cuda.current_device())
        self.n, self.L = n, cfg.nx // n
        plane = isinstance(geom, np.ndarray)
        self.geoms = shard_planes(torch.as_tensor(geom, device=dev), n) if plane else [geom] * n
        f = state_tensor(f0, cfg.dtype, dev)
        self.bufs = [[f[:, k * self.L:(k + 1) * self.L].contiguous() for k in range(n)]]
        self.bufs.append([torch.full_like(b, float("nan")) for b in self.bufs[0]])
        self.ends = [fused_kernel.rdma_end(cfg, dev) for _ in range(n)]
        self.streams = [torch.cuda.Stream(dev) for _ in range(n)]
        self.launches = [[fused_kernel.rdma_launcher(
            self.bufs[p][k], self.bufs[1 - p][k], self.ends[k], self.ends[(k - 1) % n],
            self.ends[(k + 1) % n], self.geoms[k], cfg, row_offset=k * self.L,
            fast_math=fast_math, timeout_s=timeout_s, stream=self.streams[k], form=form)
            for k in range(n)] for p in range(2)]
        self.parity, self.steps_done = 0, 0
        torch.cuda.synchronize()

    def step(self, only=None):
        self.steps_done += 1
        for k, launch in enumerate(self.launches[self.parity]):
            if only is None or k in only:
                launch(self.steps_done)
        self.parity ^= 1

    def timed_run(self, steps):
        """A call that runs `steps` steps: the shards' streams are forked
        from the current stream, and joined to it again, once per call, so
        that events on the current stream bracket the whole run."""
        cur = torch.cuda.current_stream()

        def run():
            for st in self.streams:
                st.wait_stream(cur)
            for _ in range(steps):
                self.step()
            for st in self.streams:
                cur.wait_stream(st)

        return run

    def timed_out(self):
        from latticeboltzmann_tpu_torch.ops import fused_kernel

        torch.cuda.synchronize()
        return [fused_kernel.rdma_timed_out(e) for e in self.ends]


def compare_rdma(name, cfg, geom, f0, n, steps=10, fast_math=False):
    """`steps` steps of the rdma kernel over n virtual shards of the card,
    each shard on a stream of its own, no copy from the host, in each form
    (wide, narrow) from the same start. After every step each shard's
    block and the comm rows it received are held against
    step_reference_rdma from the same inputs (bitwise, unless fast_math),
    the wide form's blocks also against its plain version, and the two
    forms' states against each other. Returns (joined state, {form: max
    |diff|})."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel

    err = dict.fromkeys(fused_kernel.FORMS, 0.0)
    states = {}
    for form in fused_kernel.FORMS:
        ring = RdmaRing(cfg, geom, f0, n, fast_math=fast_math, form=form)
        if {launch.form for p in ring.launches for launch in p} != {form}:
            raise AssertionError(f"{name}: the rdma launches did not take the {form} form")
        ref_ends = [fused_kernel.rdma_end(cfg, e.top.device) for e in ring.ends]
        for step in range(1, steps + 1):
            srcs, dsts = ring.bufs[ring.parity], ring.bufs[1 - ring.parity]
            ring.step()
            if any(ring.timed_out()):
                raise AssertionError(f"{name}: rdma launches ({form} form) of step {step} gave up "
                                     f"waiting for their neighbours' rows (error words "
                                     f"{ring.timed_out()})")
            refs = fused_kernel.step_reference_rdma(srcs, ref_ends, ring.geoms, cfg, step)
            for k in range(n):
                for side in ("top", "bot", "flags"):
                    got, want = getattr(ring.ends[k], side), getattr(ref_ends[k], side)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name}: shard {k} of {n}, step {step}: comm {side} "
                                             f"({form} form) != step_reference_rdma's")
                e = float((dsts[k].float() - refs[k].float()).abs().max())
                if not fast_math and not (torch.equal(dsts[k], refs[k]) and e <= KERNEL_ATOL):
                    bad = torch.nonzero(dsts[k] != refs[k])
                    raise AssertionError(
                        f"{name}: rdma kernel ({form} form) != step_reference_rdma on shard {k} "
                        f"of {n}, step {step}, max |diff| {e!r} at {bad.shape[0]} values (first "
                        f"{bad[:5].tolist()})")
                if (form == "wide" and not fast_math
                        and not torch.equal(dsts[k], fused_kernel.rdma_compute_reference(
                            srcs[k], ref_ends[k], ring.geoms[k], cfg, step, row_offset=k * ring.L,
                            form="wide"))):
                    raise AssertionError(f"{name}: the wide rdma kernel != its plain version on "
                                         f"shard {k} of {n}, step {step}")
                err[form] = max(err[form], e)
        states[form] = torch.cat(ring.bufs[ring.parity], dim=1)
        del ring
    if not torch.equal(states["wide"], states["narrow"]):
        raise AssertionError(f"{name}: the rdma kernel's wide form != its narrow form")
    geom_kind = ("wall-free" if geom is None else
                 ("plane" if isinstance(geom, np.ndarray) else "spec"))
    print(f"rdma kernel vs step_reference_rdma {name} ({states['wide'].dtype}, {geom_kind}, fast "
          f"math {fast_math}), {n} virtual shards, {steps} steps, forms wide == narrow, comm rows "
          f"and flags equal: max |diff| = {max(err.values())!r}")
    return states["wide"], err


def withheld_send(cfg, f0):
    """One shard of a ring of two launched alone: its edge rows wait for
    rows that never come, and must give up within the timeout, leaving the
    step in the shard's error word. Returns the seconds the launch took."""
    timeout_s = 0.25
    ring = RdmaRing(cfg, None, f0, 2, timeout_s=timeout_s)
    t0 = time.perf_counter()
    ring.step(only={0})
    words = ring.timed_out()
    took = time.perf_counter() - t0
    if words != [1, 0] or not timeout_s <= took < timeout_s + 2.0:
        raise AssertionError(f"withheld send: error words {words} (want [1, 0]) after {took!r} s "
                             f"(timeout {timeout_s} s)")
    # later launches of the failed shard skip their waits at once
    t0 = time.perf_counter()
    for _ in range(20):
        ring.step(only={0})
    ring.timed_out()
    later = time.perf_counter() - t0
    if not later < timeout_s:
        raise AssertionError(f"withheld send: 20 later launches took {later!r} s")
    print(f"rdma withheld send: shard 0 of 2 launched alone gave up after {took!r} s (timeout "
          f"{timeout_s} s), error words {words}; 20 later launches skipped their waits in "
          f"{later!r} s")
    return took


def card_mesh_size(nx):
    """The most cards, at least 2, over which nx rows split evenly; 0 on a
    machine with one card."""
    return max((n for n in range(2, torch.cuda.device_count() + 1) if nx % n == 0), default=0)


def sharded_phases(f32_main, ds_counts, clock):
    """Phases 15-17 and 22-24: the ext-halo and rdma kernels and the
    row-sharded paths. f32_main: phase 4's float32 state after WARMUP +
    MAIN_STEPS steps; ds_counts, clock: ds_phases' SASS counts and SM
    clock, for the ds ext-halo kernel's bound. Returns the kernels line's
    entries of the two ext-halo kernels and the rdma kernel."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry, initial_state
    from latticeboltzmann_tpu_torch.models import engine
    from latticeboltzmann_tpu_torch.ops import df64, fused_ds_kernel, fused_kernel
    from latticeboltzmann_tpu_torch.parallel import sharded
    from latticeboltzmann_tpu_torch.utils.interop import bytes_per_site, state_tensor, storage_dtype

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 2)

    # 15. the ext-halo kernels against their plain versions, both forms of
    # the stream-collide kernel's
    ext_err, ds_ext_err = {}, 0.0
    for name, cfg, w in scenes(np.float32):
        f0 = guard_off_at_boundaries(perturbed_state(cfg, rng), cfg.nx)
        slip_w, slip_x, slip_y = slip_scene(cfg.nx, cfg.ny)
        spec = geometry.infer_spec(w)
        geoms = {"wall-free": None, "plane": w.astype(np.uint8), "spec": spec,
                 "slip": fused_kernel.class_plane(slip_w, slip_x, slip_y)}
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        for n in (2, 4):
            for kind, g in geoms.items():
                worst(ext_err, compare_ext(f"{name}, {kind}", cfg, g, f0, n)[1])
            for kind in ("plane", "spec"):
                worst(ext_err, compare_ext(f"{name}, {kind}", cfg16, geoms[kind], f0, n)[1])
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    spec = geometry.infer_spec(walls)
    f0 = perturbed_state(cfg, rng)
    steps, bar = fused_kernel.FAST_MATH_STEPS, fused_kernel.FAST_MATH_RTOL
    got, _ = compare_ext("800x4000 reference_barrier", cfg, spec, f0, VIRTUAL_SHARDS,
                         steps=steps, fast_math=True)
    ref = state_tensor(f0, cfg.dtype, dev)
    for _ in range(steps):
        ref = fused_kernel.step_reference(ref, None, cfg, wall_spec=spec)
    fast_rel = float(((got - ref).abs() / ref.abs()).max())
    if not fast_rel <= bar:
        raise AssertionError(f"ext-halo fast math after {steps} steps: max rel {fast_rel!r} > {bar}")
    print(f"ext-halo fast-math kernel, {VIRTUAL_SHARDS} virtual shards, vs the single-chip "
          f"step_reference (IEEE 1/rho) after {steps} chained steps: max rel {fast_rel!r} "
          f"(bar {bar})")
    for name, cfg64, w in scenes(np.float64):
        f = initial_state(cfg64)
        f64 = guard_off_at_boundaries(f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape)),
                                      cfg64.nx)
        for n in (2, 4):
            for exact in (False, True):
                ds_ext_err = max(ds_ext_err, compare_ds_ext(name, cfg64, w, f64, n, exact))

    # 22. the rdma kernel against its plain version, both forms, and a
    # withheld send
    rdma_err = {}
    for name, cfg_s, w in scenes(np.float32):
        f0_s = guard_off_at_boundaries(perturbed_state(cfg_s, rng), cfg_s.nx)
        slip_w, slip_x, slip_y = slip_scene(cfg_s.nx, cfg_s.ny)
        spec_s = geometry.infer_spec(w)
        geoms = {"wall-free": None, "plane": w.astype(np.uint8), "spec": spec_s,
                 "slip": fused_kernel.class_plane(slip_w, slip_x, slip_y)}
        cfg16 = dataclasses.replace(cfg_s, dtype="bfloat16")
        for n in (2, 4):
            for kind, g in geoms.items():
                worst(rdma_err, compare_rdma(f"{name}, {kind}", cfg_s, g, f0_s, n)[1])
            for kind in ("plane", "spec"):
                worst(rdma_err, compare_rdma(f"{name}, {kind}", cfg16, geoms[kind], f0_s, n)[1])
    got, _ = compare_rdma("800x4000 reference_barrier", cfg, spec, f0, VIRTUAL_SHARDS,
                          steps=steps, fast_math=True)
    rdma_fast_rel = float(((got - ref).abs() / ref.abs()).max())
    if not rdma_fast_rel <= bar:
        raise AssertionError(f"rdma fast math after {steps} steps: max rel {rdma_fast_rel!r} > {bar}")
    print(f"rdma fast-math kernel, {VIRTUAL_SHARDS} virtual shards, vs the single-chip "
          f"step_reference (IEEE 1/rho) after {steps} chained steps: max rel {rdma_fast_rel!r} "
          f"(bar {bar})")
    del got, ref
    withheld_send(cfg, f0)

    # 16. the sharded main paths, every launch counted
    meshes = {"1 shard": sharded.make_mesh(devices=[dev]),
              f"{VIRTUAL_SHARDS} virtual shards": sharded.make_mesh(
                  devices=[dev] * VIRTUAL_SHARDS)}
    n_cards = card_mesh_size(cfg.nx)
    if n_cards:
        meshes[f"{n_cards} cards"] = sharded.make_mesh(n_cards)
    print(f"sharded meshes: {', '.join(f'{k} {[str(d) for d in m.devices]}' for k, m in meshes.items())}")
    sims = {}
    by_form = {}  # (backend, mesh label, NY): the path's launches by form

    def launches_per_step(mesh, overlap=True):
        L = cfg.nx // mesh.size
        return mesh.size * (3 if overlap and L >= 3 else 1)

    def default_forms(mesh, steps):
        """The ext-halo launches by form of `steps` steps of the overlap
        schedule where the wide form applies: each shard's interior wide,
        its two one-row launches narrow (fused_kernel.ext_launcher's
        default)."""
        return {"wide": steps * mesh.size, "narrow": steps * 2 * mesh.size}

    def sharded_path(label, backend, make, mesh, cfg_, n_steps, key, per_step, want, warmup=0,
                     copies_per_step=None, session_copies=0, form="wide", scene=None, **options):
        """Register `backend` over `mesh`, drive it through Simulation for
        warmup + n_steps counted steps, the stream-collide launches of
        `form` (expect_counts), on `scene` (default: the reference scene's
        walls) and hold its state bitwise to `want`; with copies_per_step
        also the halo copies the host started (and session_copies once: a
        session's static halo class rows)."""
        engine.register_backend(backend, make(mesh))
        reset_counts()
        sharded.HALO_COPIES = 0
        sim = Simulation(cfg_, walls if scene is None else scene, backend=backend, **options)
        sim.run(warmup)
        sim.elapsed, sim.steps_done = 0.0, 0
        sim.run(n_steps)
        n = expect_counts(f"{backend} over {label}",
                          {key: (warmup + n_steps) * per_step}, form)[key]
        by_form[backend, label, cfg_.ny] = dict(fused_kernel.EXT_FORM_LAUNCHES
                                                + fused_kernel.RDMA_FORM_LAUNCHES)
        copies = sharded.HALO_COPIES
        if (copies_per_step is not None
                and copies != (warmup + n_steps) * copies_per_step + session_copies):
            raise AssertionError(f"{backend} over {label}: {copies} halo copies from the host, "
                                 f"expected {copies_per_step} per step")
        got = sim.state()
        if not np.array_equal(got, want):
            raise AssertionError(f"{backend} over {label}: state != the single-chip path's after "
                                 f"{warmup + n_steps} steps, max |diff| "
                                 f"{float(np.abs(got - want).max())!r}")
        print(f"{backend} over {label}: {warmup + n_steps} steps at {cfg_.nx}x{cfg_.ny}, {n} "
              f"counted {key} launches ({per_step} per step; by form {form}), {copies} halo "
              f"copies from the host, bitwise equal to the single-chip path, Re "
              f"{sim.reynolds()!r}, {sim.mlups!r} MLUPS ({sim.elapsed!r} s)")
        if scene is None:
            sims[f"{backend}, {label}"] = sim
        return n

    key = f"ext-{fused_kernel.variant_name(torch.float32, 'spec', False, False)}"
    for label, mesh in meshes.items():
        sharded_path(
            label, "sharded-cuda", lambda m: sharded.make_cuda_backend(m, overlap=True), mesh,
            cfg, MAIN_STEPS, key, launches_per_step(mesh), f32_main, warmup=WARMUP,
            form=default_forms(mesh, WARMUP + MAIN_STEPS))
    # 23. the rdma path: one launch per shard and step, no copy from the host
    rdma_key = f"rdma-{fused_kernel.variant_name(torch.float32, 'spec', False, False)}"
    rdma_launches = {}
    for label, mesh in meshes.items():
        if mesh.size == 1:
            continue
        rdma_launches[label] = sharded_path(
            label, "sharded-cuda-rdma", lambda m: sharded.make_cuda_backend(m, rdma=True), mesh,
            cfg, MAIN_STEPS, rdma_key, mesh.size, f32_main, warmup=WARMUP, copies_per_step=0,
            allow_experimental=True)
    if not n_cards:
        print("one card visible: the rdma path over a mesh of cards (peer pointers between "
              "cards) was not run")
    mesh4 = meshes[f"{VIRTUAL_SHARDS} virtual shards"]
    # the narrow forms' sharded paths: an NY the wide forms do not take
    cfg_n = LatticeConfig(nx=800, ny=NARROW_NY, dtype=np.float32)
    walls_n = geometry.reference_barrier(cfg_n.nx, cfg_n.ny)
    want = Simulation(cfg_n, walls_n, backend="cuda").run(NARROW_SHARDED_STEPS).state()
    label4 = f"{VIRTUAL_SHARDS} virtual shards"
    narrow_launches = {
        "ext": sharded_path(f"{VIRTUAL_SHARDS} virtual shards", "sharded-cuda",
                            lambda m: sharded.make_cuda_backend(m, overlap=True), mesh4, cfg_n,
                            NARROW_SHARDED_STEPS, key, launches_per_step(mesh4), want,
                            form="narrow", scene=walls_n),
        "rdma": sharded_path(f"{VIRTUAL_SHARDS} virtual shards", "sharded-cuda-rdma",
                             lambda m: sharded.make_cuda_backend(m, rdma=True), mesh4, cfg_n,
                             NARROW_SHARDED_STEPS, rdma_key, mesh4.size, want, copies_per_step=0,
                             form="narrow", scene=walls_n, allow_experimental=True)}
    want = Simulation(cfg, walls, backend="cuda").run(FUSED_STEPS).state()
    sharded_path(f"{VIRTUAL_SHARDS} virtual shards", "sharded-cuda-fused",
                 lambda m: sharded.make_cuda_backend(m, overlap=False), mesh4, cfg, FUSED_STEPS,
                 key, launches_per_step(mesh4, overlap=False), want)
    cfg64 = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    want = Simulation(cfg64, walls, backend="cuda-ds64").run(DS_SHARDED_STEPS).state()
    # passes of DS_TEMPORAL through the ext-halo temporal form, one launch
    # per shard and pass (the backend's default schedule), the T-row halos
    # of both components copied once per pass
    T = fused_ds_kernel.DS_TEMPORAL
    sharded_path(
        f"{VIRTUAL_SHARDS} virtual shards", "sharded-cuda-ds64", sharded.make_cuda_ds_backend,
        mesh4, cfg64, DS_SHARDED_STEPS, "ds-ext-temporal", mesh4.size / T, want,
        copies_per_step=2 * 2 * mesh4.size / T, session_copies=2 * mesh4.size)
    # the one-step ext-halo form where the temporal form does not apply: an
    # NY of no whole 16-byte vectors, one launch per shard and step
    cfg64_n = LatticeConfig(nx=800, ny=NARROW_NY, dtype=np.float64)
    want = Simulation(cfg64_n, walls_n, backend="cuda-ds64").run(NARROW_SHARDED_STEPS).state()
    ds_launches = sharded_path(
        f"{VIRTUAL_SHARDS} virtual shards", "sharded-cuda-ds64", sharded.make_cuda_ds_backend,
        mesh4, cfg64_n, NARROW_SHARDED_STEPS, "ds-ext", mesh4.size, want,
        copies_per_step=2 * 2 * mesh4.size, session_copies=2 * mesh4.size, scene=walls_n)
    del want

    # 17. times, in turns: each path's us/step end to end (a sync per
    # run) with the host's enqueue time, and the halo exchange per step
    def path_ms(sim, n):
        sim.elapsed, sim.steps_done = 0.0, 0
        t0 = time.perf_counter()
        sim.run(n, block=False)
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3, enqueue / n * 1e3

    def paths_in_turns(rates, group, n):
        for label in list(group) + list(reversed(group)):
            ms, enq = path_ms(group[label], n)
            rates(f"{label} (host clock, {n} steps, in turns; enqueue {enq * 1e3!r} us/step)",
                  ms * 1e-3)

    rates = rates_printer(cfg, bytes_per_site(np.float32))
    f32_paths = {"cuda": Simulation(cfg, walls, backend="cuda")}
    f32_paths.update({k: s for k, s in sims.items() if not k.startswith("sharded-cuda-ds64")})
    paths_in_turns(rates, f32_paths, 2000)
    rates64 = rates_printer(cfg64, fused_ds_kernel.BYTES_PER_SITE_DS)
    ds_key = f"sharded-cuda-ds64, {VIRTUAL_SHARDS} virtual shards"
    paths_in_turns(rates64, {"cuda-ds64": Simulation(cfg64, walls, backend="cuda-ds64"),
                             ds_key: sims[ds_key]}, 1000)
    def exchange_only(sess):
        """One pass's halo copies from the session's plan (a step's, or a
        pass of sess.temporal steps'), no launches."""
        copies = sess._plans[sess._parity][0]
        return lambda: (sess.exchange.start(copies), sess.exchange.finish())

    for label in (f"sharded-cuda, {VIRTUAL_SHARDS} virtual shards", ds_key):
        sess = sims[label]._session
        ms = event_ms(exchange_only(sess), 500)
        print(f"halo exchange alone, {label}: {ms * 1e3!r} us a pass of {sess.temporal} step(s), "
              f"{ms * 1e3 / sess.temporal!r} us/step (CUDA events, 500 exchanges)")
    del sims, f32_paths

    # the ext-halo kernels' launches of one step at the main path's
    # shapes, halos in place, beside the single-chip launch: both forms, in
    # float32 and bf16, as the host launches them (event_ms), then the
    # card's own time (queued_ms), which the kernels line reports
    n, L = VIRTUAL_SHARDS, cfg.nx // VIRTUAL_SHARDS
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    full = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    ext_t, ext_bound, fused_calls = {}, {}, {}
    for c in (cfg, cfg16):
        st = "bf16" if c is cfg16 else "f32"
        a = full.to(storage_dtype(c.dtype))
        out = torch.empty_like(a)
        srcs = [a[:, k * L:(k + 1) * L].contiguous() for k in range(n)]
        dsts = [torch.empty_like(x) for x in srcs]
        halos = ring_halos(srcs)
        group = {"single-chip kernel (1 launch)": lambda a=a, out=out, c=c: fused_kernel.step(
            a, out, spec, c)}
        for form in (None, *fused_kernel.FORMS):
            calls = [call for k in range(n) for call in ext_calls(
                fused_kernel.ext_launcher, L, srcs[k], dsts[k], halos[k], spec, cfg=c,
                row_offset=k * L, form=form)]
            name = (f"{form} form" if form else
                    "default forms (interiors wide, one-row launches narrow)")
            group[f"ext-halo, {name}, {n} shards, interior + edges ({len(calls)} launches)"] = (
                lambda calls=calls: [call() for call in calls])
            if form:
                fused_calls[st, form] = [fused_kernel.ext_launcher(
                    srcs[k], dsts[k], halos[k], spec, c, row_offset=k * L, form=form)
                    for k in range(n)]
                group[f"ext-halo, {form} form, {n} shards, one launch per shard ({n})"] = (
                    lambda calls=fused_calls[st, form]: [call() for call in calls])
        rates_c = rates_printer(c, bytes_per_site(c.dtype))
        in_turns(rates_c, f"{st} spec, one step's launches", group, 500)
        ext_t[st] = in_turns(rates_c, f"{st} spec, one step's launches", group, 50,
                             timer=queued_ms)
        halo_bytes = sum(h.numel() * h.element_size() for pair in halos for h in pair)
        ext_bound[st] = bound(2 * a.numel() * a.element_size() + halo_bytes,
                              F32_OPS_PER_SITE * cfg.sites)
        if c is cfg:
            ext_plain_ms = event_ms(lambda: [fused_kernel.step_reference_ext(
                srcs[k], halos[k], spec, cfg, row_offset=k * L) for k in range(n)], 20)
            rates(f"step_reference_ext over {n} shards, its plain version (CUDA events, 20 steps)",
                  ext_plain_ms * 1e-3)

    def ext_ms(st, form, what):
        """The best queued time of `st`'s ext-halo launches of `form`
        ("wide", "narrow", "default") and schedule ("interior" + edges, or
        "one launch" per shard)."""
        return next(ms for label, ms in ext_t[st].items() if f"{form} form" in label and what in label)

    # 24. one step's rdma launches, one per shard on its own stream: the
    # card's own time over RDMA_TIMED_STEPS steps queued behind a spin,
    # streams forked from and joined to the timed stream once per run; both
    # forms in turns, in float32 and bf16, beside the ext-halo form's one
    # launch per shard
    f_host = full.cpu().numpy()
    rdma_t, rdma_bound = {}, {}
    for c in (cfg, cfg16):
        st = "bf16" if c is cfg16 else "f32"
        rings = {form: RdmaRing(c, spec, f_host, n, form=form) for form in fused_kernel.FORMS}
        fns = {f"rdma, {form} form, {n} shards, one launch per shard ({n}), no host copies":
               rings[form].timed_run(RDMA_TIMED_STEPS) for form in fused_kernel.FORMS}

        def fused_steps(calls=fused_calls[st, "wide"]):
            for _ in range(RDMA_TIMED_STEPS):
                for call in calls:
                    call()

        fns[f"ext-halo, wide form, {n} shards, one launch per shard ({n}), halos in place"] = (
            fused_steps)
        rates_c = rates_printer(c, bytes_per_site(c.dtype))
        t = in_turns(lambda label, sec, rates_c=rates_c: rates_c(label, sec / RDMA_TIMED_STEPS),
                     f"{st} spec, {RDMA_TIMED_STEPS} steps' launches", fns, 3, timer=queued_ms)
        for form, ring in rings.items():
            if any(ring.timed_out()):
                raise AssertionError(f"rdma timing run ({form} form): error words "
                                     f"{ring.timed_out()}")
        rdma_t[st] = {form: next(ms for label, ms in t.items() if label.startswith(
            f"rdma, {form} form")) / RDMA_TIMED_STEPS for form in fused_kernel.FORMS}
        # the ext-halo form's bytes, and per shard 2 rows sent and 2 received
        elem = torch.empty((), dtype=storage_dtype(c.dtype)).element_size()
        rdma_bound[st] = bound(2 * full.numel() * elem + n * 4 * 9 * c.ny * elem,
                               F32_OPS_PER_SITE * cfg.sites)
        del rings
    # rings of other sizes (1: the ring of one, its own neighbour)
    for n_r in (1, 2, 8):
        ring_r = RdmaRing(cfg, spec, f_host, n_r)
        ms = queued_ms(ring_r.timed_run(RDMA_TIMED_STEPS), 3) / RDMA_TIMED_STEPS
        if any(ring_r.timed_out()):
            raise AssertionError(f"rdma timing run, {n_r} shards: error words {ring_r.timed_out()}")
        rates(f"f32 spec, {RDMA_TIMED_STEPS} steps' launches, rdma ({ring_r.launches[0][0].form} "
              f"form), {n_r} shards, one launch per shard (CUDA events, 3 calls, queued behind a "
              f"spin)", ms * 1e-3)
        del ring_r
    srcs = [full[:, k * L:(k + 1) * L].contiguous() for k in range(n)]
    rdma_ends = [fused_kernel.rdma_end(cfg, dev) for _ in range(n)]
    plain_step = iter(range(1, 1000))
    rdma_plain_ms = event_ms(lambda: fused_kernel.step_reference_rdma(
        srcs, rdma_ends, [spec] * n, cfg, next(plain_step)), 20)
    rates(f"step_reference_rdma over {n} shards, its plain version (CUDA events, 20 steps)",
          rdma_plain_ms * 1e-3)
    del rdma_ends, full, srcs, fused_calls

    f = initial_state(cfg64)
    a = df64.from_f64(f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape)), dev)
    b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    planes = shard_planes(solid, n)
    srcs = [df64.DS(a.hi[:, k * L:(k + 1) * L].contiguous(), a.lo[:, k * L:(k + 1) * L].contiguous())
            for k in range(n)]
    dsts = [df64.DS(torch.empty_like(s.hi), torch.empty_like(s.lo)) for s in srcs]
    his, los = ring_halos([s.hi for s in srcs]), ring_halos([s.lo for s in srcs])
    halos = [tuple(df64.DS(h, lo) for h, lo in zip(his[k], los[k])) for k in range(n)]
    ds_calls, ds_fused_calls = [], []
    for k in range(n):
        ds_calls += ext_calls(fused_ds_kernel.ext_launcher, L, srcs[k], dsts[k], halos[k],
                              planes[k], cfg=cfg64, has_walls=True)
        # ShardedDSSession(overlap=False)'s schedule: one launch per shard
        ds_fused_calls.append(fused_ds_kernel.ext_launcher(srcs[k], dsts[k], halos[k], planes[k],
                                                           cfg64, has_walls=True))
    overlap = f"ext-halo, {n} shards, interior + edges ({len(ds_calls)} launches)"
    fused = f"ext-halo, {n} shards, one launch per shard ({n})"
    group = {
        "single-chip kernel (1 launch)": lambda: fused_ds_kernel.step(a, b, solid, cfg64,
                                                                      has_walls=True),
        overlap: lambda: [c() for c in ds_calls],
        fused: lambda: [c() for c in ds_fused_calls],
    }
    in_turns(rates64, "ds fast tier, one step's launches", group, 200)
    t = in_turns(rates64, "ds fast tier, one step's launches", group, 50, timer=queued_ms)
    ds_ext_ms, ds_fused_ms = t[overlap], t[fused]
    ds_ext_plain_ms = event_ms(lambda: [fused_ds_kernel.step_reference_ext(
        srcs[k].hi, srcs[k].lo, halos[k], planes[k], cfg64, False) for k in range(n)], 3)
    rates64(f"ds step_reference_ext over {n} shards, its plain version (CUDA events, 3 steps)",
            ds_ext_plain_ms * 1e-3)
    # halo rows: both components of each, and their class rows
    halo_bytes = sum(c.numel() * 4 for h in halos for pair in h for c in pair)
    halo_bytes += sum(p.top.numel() + p.bot.numel() for p in planes)
    ds_bound = counted_bound(4 * a.hi.numel() * 4 + solid.numel() + halo_bytes,
                             ds_counts[("ds_ext", True, False)], cfg64.sites, clock)

    ext_main = by_form["sharded-cuda", label4, cfg.ny]
    return [
        {"name": "lbm_stream_collide_ext_wide<float, spec, 4> (row-sharded ext-halo form, "
                 f"wide; {VIRTUAL_SHARDS} virtual shards, interior + edge launches, the one-row "
                 "edge launches in the narrow form lbm_stream_collide_ext<float, spec> of "
                 "lbm_step.cu by default; beside it each form alone, and bf16)",
         "route": "cuda", "source": "latticeboltzmann_tpu_torch/csrc/lbm_wide_ext_step.cu",
         "narrow_form_source": "latticeboltzmann_tpu_torch/csrc/lbm_step.cu",
         "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1757 (external_halo=True)",
         "launches": ext_main["wide"],
         "narrow_form_launches": ext_main["narrow"] + narrow_launches["ext"],
         "max_abs_err": max(ext_err.values()), "max_rel_err_fast_math": fast_rel,
         "ms": ext_ms("f32", "default", "interior"),
         "wide_form_ms": ext_ms("f32", "wide", "interior"),
         "narrow_form_ms": ext_ms("f32", "narrow", "interior"),
         "one_launch_per_shard_ms": ext_ms("f32", "wide", "one launch"),
         "one_launch_per_shard_narrow_form_ms": ext_ms("f32", "narrow", "one launch"),
         "bf16_ms": ext_ms("bf16", "default", "interior"),
         "bf16_wide_form_ms": ext_ms("bf16", "wide", "interior"),
         "bf16_narrow_form_ms": ext_ms("bf16", "narrow", "interior"),
         "bf16_one_launch_per_shard_ms": ext_ms("bf16", "wide", "one launch"),
         "bf16_one_launch_per_shard_narrow_form_ms": ext_ms("bf16", "narrow", "one launch"),
         "bf16_bound_ms": ext_bound["bf16"]["bound_ms"], "plain_ms": ext_plain_ms,
         **ext_bound["f32"]},
        {"name": "lbm_stream_collide_rdma_wide<float, spec, 4> (row-sharded, the halo exchange "
                 f"inside the kernel, wide; {VIRTUAL_SHARDS} virtual shards, one launch per shard; "
                 "beside it the narrow form lbm_stream_collide_rdma<float, spec> of lbm_step.cu, "
                 "and bf16)",
         "route": "cuda", "source": "latticeboltzmann_tpu_torch/csrc/lbm_wide_ext_step.cu",
         "narrow_form_source": "latticeboltzmann_tpu_torch/csrc/lbm_step.cu",
         "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1757 (rdma=True)",
         "launches": rdma_launches[label4], "narrow_form_launches": narrow_launches["rdma"],
         "max_abs_err": max(rdma_err.values()), "max_rel_err_fast_math": rdma_fast_rel,
         "ms": rdma_t["f32"]["wide"], "narrow_form_ms": rdma_t["f32"]["narrow"],
         "bf16_ms": rdma_t["bf16"]["wide"], "bf16_narrow_form_ms": rdma_t["bf16"]["narrow"],
         "bf16_bound_ms": rdma_bound["bf16"]["bound_ms"], "plain_ms": rdma_plain_ms,
         "ext_halo_one_launch_per_shard_ms": ext_ms("f32", "wide", "one launch"),
         **rdma_bound["f32"]},
        {"name": "lbm_stream_collide_ds ext-halo form (row-sharded; "
                 f"{VIRTUAL_SHARDS} virtual shards, fast tier, masked)",
         "route": "cuda", "source": "latticeboltzmann_tpu_torch/csrc/lbm_ds_step.cu",
         "replaces": "latticeboltzmann_tpu/ops/fused_ds_kernel.py:272",
         "launches": ds_launches, "max_abs_err": ds_ext_err,
         "ms": ds_ext_ms, "one_launch_per_shard_ms": ds_fused_ms,
         "plain_ms": ds_ext_plain_ms, **ds_bound},
    ]


# the anatomy path's small run: --steps of anatomy.main in phase 20
ANATOMY_STEPS = 48
# the flat kernel's full-width check: FLAT_STEPS steps in chunks of FLAT_CHUNK
FLAT_CHUNK = 16
FLAT_STEPS = 1008
# the mechanism of each roll that is not the shared-memory one
ROLL_MECHANISM = {"roll_y": {"mechanism": "shuffle"}, "roll_x": {"mechanism": "global"}}


def roll_shifts(n):
    """Phase 18's shifts of a roll along an axis of n: every residue mod 4,
    one that crosses segments, and the axis's end."""
    return (1, 2, 3, 4, 5, 96, n - 1, n - 2, n)


# what the loop over rolls of each wide roll kernel holds, and only it
# (opcodes as cuobjdump prints them, without modifiers): the x-roll's
# shared loads and stores (LDS, STS) and no global access, which tells it
# from the loops that load the block in and store it out; the y-roll's
# shared loads, its asynchronous stores into the cluster's CTAs (STAS)
# and its mbarrier waits and arrivals (SYNCS). The one-warp x-roll keeps
# no barrier instruction there: its __syncwarp orders one warp's shared
# accesses, which the SM issues in order, and compiles to nothing.
ROLL_SASS_NEEDS = {
    "x": (("LDS",), ("STS",)),
    "y": (("LDS",), ("STAS",), ("SYNCS",)),
}
ROLL_SASS_GLOBAL = ("LDG", "STG")


def roll_sass():
    """The SASS of the wide roll kernels (cuobjdump of the built library,
    read by utils/sass.py): in lbm_roll_x_wide and each of the four
    lbm_roll_y_cluster<R> some loop, the loop over rolls, holds what
    ROLL_SASS_NEEDS says and no global load or store; prints that loop's
    moves and barriers for each. Raises otherwise."""
    import re

    from latticeboltzmann_tpu_torch.ops import cuda_build
    from latticeboltzmann_tpu_torch.utils import sass

    shown = ("LDS", "STS", "STAS", "BAR", "NOP", "WARPSYNC", "SYNCS", "UCGABAR_ARV",
             "UCGABAR_WAIT", "MEMBAR", "CCTL")
    checked = 0
    for name, instrs in sass.functions(sass.disassemble(cuda_build.build())).items():
        m = re.search(r"lbm_roll_(x_wide|y_clusterILi(\d)E)", name)
        if not m:
            continue
        kind = "x" if m.group(1) == "x_wide" else "y"
        label = "lbm_roll_x_wide" if kind == "x" else f"lbm_roll_y_cluster<{m.group(2)}>"
        holding = [(lo, hi, body) for lo, hi, body in sass.loops(instrs)
                   if all(any(op in body for op in group) for group in ROLL_SASS_NEEDS[kind])
                   and not any(body[op] for op in ROLL_SASS_GLOBAL)]
        if not holding:
            loops = [(hex(lo), hex(hi), dict(body)) for lo, hi, body in sass.loops(instrs)]
            raise AssertionError(f"{label}: no loop holds {ROLL_SASS_NEEDS[kind]} without a "
                                 f"global access: {loops}")
        lo, hi, body = holding[-1]
        print(f"SASS {label}: the loop over rolls {lo:#06x}-{hi:#06x} holds "
              f"{ {op: body[op] for op in shown if body[op]} }")
        checked += 1
    if checked != 5:
        raise AssertionError(f"found {checked} of the 5 wide roll kernels in the SASS")


def roll_times(kind, x, n_rolls, n1):
    """Phase 20's times of a roll probe on the block x: ns per roll of each
    form (and of the other mechanism) as the slope between n1 and 2 * n1
    rolls by 1, in turns; one launch of n_rolls rolls by 1 (the JAX
    probe's count) and one of no roll of each form queued behind a spin,
    in turns, beside one torch.roll by n_rolls (the library call) and by
    1, and n_rolls chained torch.roll (the plain version). Returns the
    kernels line's keys."""
    from latticeboltzmann_tpu_torch.ops import probes
    from latticeboltzmann_tpu_torch.scripts import anatomy

    roll, reference = ((probes.roll_y, probes.roll_y_reference) if kind == "roll_y"
                       else (probes.roll_x, probes.roll_x_reference))
    axis = 1 if kind == "roll_y" else 0
    out = torch.empty_like(x)
    other = ROLL_MECHANISM[kind]["mechanism"]
    kws = {"wide": {"form": "wide"}, "narrow": {"form": "narrow"}, other: ROLL_MECHANISM[kind]}
    per_roll = {}
    for label in ("wide", "narrow", other, other, "narrow", "wide"):
        dt = timed_slope(lambda n: roll(x, 1, n, out=out, **kws[label]), n1, 2 * n1) * 1e9
        print(f"{kind} {tuple(x.shape)}, shift 1, {label}: {dt!r} ns/roll (slope {n1}/{2 * n1}, "
              "in turns)")
        per_roll[label] = min(per_roll.get(label, dt), dt)
    fns = {"wide": lambda: roll(x, 1, n_rolls, out=out, form="wide"),
           "narrow": lambda: roll(x, 1, n_rolls, out=out, form="narrow"),
           # a launch's fixed part: the block in and out, no roll
           "wide, no roll": lambda: roll(x, 1, 0, out=out, form="wide"),
           "narrow, no roll": lambda: roll(x, 1, 0, out=out, form="narrow"),
           f"one torch.roll by {n_rolls}": lambda: torch.roll(x, n_rolls, axis),
           "one torch.roll by 1": lambda: torch.roll(x, 1, axis)}
    per_launch = {}
    for label in (*fns, *reversed(fns)):
        ms = queued_ms(fns[label], 200)
        print(f"{kind} {tuple(x.shape)}, {label}: {ms * 1e3!r} us per launch (queued behind a "
              "spin, in turns)")
        per_launch[label] = min(per_launch.get(label, ms), ms)
    plain_ms = queued_ms(lambda: reference(x, 1, n_rolls), 50)
    lib_ms = per_launch[f"one torch.roll by {n_rolls}"]
    onchip = 2 * x.numel() * 4
    # the bound over the SMs the narrow form's launch occupies
    narrow_ctas = x.shape[0] if kind == "roll_y" else -(-x.shape[1] // 128)
    sms = min(narrow_ctas, torch.cuda.get_device_properties(0).multi_processor_count)
    form = probes.DEFAULT_FORM[kind]
    entry = {
        "form": form, "ms": per_launch[form], "wide_form_ms": per_launch["wide"],
        "narrow_form_ms": per_launch["narrow"],
        "no_roll_ms": {"wide": per_launch["wide, no roll"],
                       "narrow": per_launch["narrow, no roll"]},
        "plain_ms": plain_ms, **bound(onchip, 0), "library_ms": lib_ms,
        "wide_over_library": per_launch["wide"] / lib_ms,
        "narrow_over_library": per_launch["narrow"] / lib_ms,
        "ns_per_roll": per_roll, "library_ns_per_roll": per_launch["one torch.roll by 1"] * 1e6,
        "smem_bound_ns_per_roll": anatomy.onchip_bound_s(onchip) * 1e9,
        "smem_bound_ns_per_roll_over_narrow_launch_sms":
            onchip / (anatomy.SMEM_BYTES_PER_CLOCK * anatomy.SM_CLOCK_HZ * sms) * 1e9,
    }
    if kind == "roll_y":
        entry.update(cluster=probes.ROLL_Y_CLUSTER,
                     max_active_clusters=probes.roll_y_clusters(*x.shape))
    else:
        entry.update(vectors=probes.ROLL_X_VECTORS, warps=1,
                     ctas=-(-x.shape[1] // (4 * probes.ROLL_X_VECTORS)))
    print(f"{kind}, {n_rolls} rolls of {tuple(x.shape)}: wide {per_launch['wide'] * 1e3!r} us, "
          f"narrow {per_launch['narrow'] * 1e3!r} us, {n_rolls} chained torch.roll "
          f"{plain_ms * 1e3!r} us, one torch.roll by {n_rolls} {lib_ms * 1e3!r} us: the wide form "
          f"takes {entry['wide_over_library']!r} of the library call's time, the narrow "
          f"{entry['narrow_over_library']!r}; per roll {per_roll['wide']!r} ns wide, "
          f"{per_roll['narrow']!r} narrow, card-wide bound {entry['smem_bound_ns_per_roll']!r}; "
          f"the default form: {form}")
    return entry


def bitwise(label, got, want):
    """Raise unless got == want bitwise; returns max |got - want| (0.0)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        d = (got.float() - want.float()).abs()
        raise AssertionError(f"{label}: kernel != its plain version, max |diff| "
                             f"{float(d.max())!r} at {int((got != want).sum())} values")
    return float((got.float() - want.float()).abs().max())


def anatomy_phases():
    """Phases 18-20: the four probe kernels and the flat kernel against
    their plain versions, the flat kernel at full width against the cuda
    backend, the anatomy path itself (its launches counted), and times.
    Returns the five kernels' entries of the kernels line."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.ops import fused_kernel, probes
    from latticeboltzmann_tpu_torch.scripts import anatomy
    from latticeboltzmann_tpu_torch.utils.interop import bytes_per_site, state_tensor

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)

    def rand(shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=dev).sub_(0.5).to(dtype)

    # 18. the probes against their plain versions, bitwise
    reset_counts()
    err = {"copy": 0.0, "roll_y": 0.0, "align": 0.0, "roll_x": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for nx, ny in ((800, 4000), (24, 40), (24, 37)):
            a = rand((9, nx, ny), dtype)
            want = probes.copy_reference(a)
            forms = [{}, {"ctas_per_sm": 8}] + [{"rows": r, "stages": st}
                                                for r, st in ((1, 2), (2, 4), (4, 3), (8, 2))]
            taken = 0
            for kw in forms:
                b = torch.zeros_like(a)
                try:
                    probes.copy_state(a, b, **kw)
                except ValueError:  # a tile of no whole 16-byte vectors, or too large
                    continue
                err["copy"] = max(err["copy"], bitwise(f"copy {kw} {dtype} {nx}x{ny}", b, want))
                taken += 1
            if taken < 3:
                raise AssertionError(f"copy {dtype} {nx}x{ny}: no staged form was taken")
            print(f"copy kernel vs src.clone() ({dtype}, {nx}x{ny}): direct (covering and "
                  f"persistent grid) and {taken - 2} staged forms bitwise")
    for rows, ny in ((40, 4000), (40, 37)):
        x = rand((rows, ny))
        for axis in (0, 1):
            for offset in (0, 1, 2):
                for n in (0, 8):
                    err["align"] = max(err["align"], bitwise(
                        f"align {rows}x{ny} axis {axis} offset {offset} n {n}",
                        probes.align(x, offset, n, axis=axis),
                        probes.align_reference(x, offset, n, axis)))
    print("alignment kernel (offsets 0, 1, 2; rows and columns) vs its plain version at "
          "(40, 4000), (40, 37): bitwise")
    # the rolls: both forms of the shared-memory mechanism (the wide one
    # wherever it takes NY) and form=None, the shuffle and global
    # mechanisms, each against its plain version and one torch.roll by the
    # summed shift; the wide form must run at 4000 columns and refuse 37,
    # where the narrow form runs
    for kind, roll, reference, rows, counts_n, axis, wide_takes in (
            ("roll_y", probes.roll_y, probes.roll_y_reference, 32, (0, 1, 6, 7), 1,
             lambda ny: ny % (4 * probes.ROLL_Y_CLUSTER) == 0),
            ("roll_x", probes.roll_x, probes.roll_x_reference, 40, (0, 1, 6, 7, 8, 9), 0,
             lambda ny: ny % 4 == 0)):
        for ny in (4000, 40, 37):
            x = rand((rows, ny))
            before = dict(probes.ROLL_FORM_LAUNCHES)
            variants = [{"form": "narrow"}, {}, ROLL_MECHANISM[kind]]
            if wide_takes(ny):
                variants.append({"form": "wide"})
            shifts = sorted({*roll_shifts(ny), *((1, rows - 1) if kind == "roll_x" else ())})
            for shift in shifts:
                for n in counts_n:
                    for kw in variants:
                        try:
                            got = roll(x, shift, n, **kw)
                        except ValueError:  # shuffles take |shift| < 32 only
                            if kw != {"mechanism": "shuffle"}:
                                raise
                            continue
                        label = f"{kind} {rows}x{ny} shift {shift} n {n} {kw}"
                        err[kind] = max(err[kind], bitwise(label, got, reference(x, shift, n)))
                        bitwise(f"{label} vs one torch.roll", got,
                                torch.roll(x, n * shift % x.shape[axis], axis))
            if not wide_takes(ny):
                try:
                    roll(x, 1, 6, form="wide")
                except ValueError:
                    pass
                else:
                    raise AssertionError(f"{kind} {rows}x{ny}: form='wide' did not refuse")
            forms = {k: probes.ROLL_FORM_LAUNCHES[k] - before.get(k, 0)
                     for k in (f"{kind}-wide", f"{kind}-narrow")}
            if (ny == 4000 and not forms[f"{kind}-wide"]) or \
                    (ny == 37 and (forms[f"{kind}-wide"] or not forms[f"{kind}-narrow"])):
                raise AssertionError(f"{kind} {rows}x{ny}: launches by form {forms}")
            print(f"{kind} kernels vs their plain versions and one torch.roll, ({rows}, {ny}), "
                  f"shifts {shifts}, n {counts_n}, forms and mechanisms {variants}: bitwise; "
                  f"launches by form {forms}")
    active = probes.roll_y_clusters(32, 4000)
    if active < 1:
        raise AssertionError("no cluster of the wide y-roll fits the card")
    print(f"wide y-roll at (32, 4000): {32 * probes.ROLL_Y_CLUSTER} CTAs in clusters of "
          f"{probes.ROLL_Y_CLUSTER}, cudaOccupancyMaxActiveClusters {active}")
    roll_sass()
    counts18 = read_counts()
    missing = {"copy-direct", "copy-staged", "roll_y-shared", "roll_y-shuffle", "align-axis0",
               "align-axis1", "roll_x-shared", "roll_x-global"} - set(counts18)
    if missing:
        raise AssertionError(f"phase 18 launched no {sorted(missing)}: {counts18}")
    print(f"phase 18 probe launches: {counts18}")

    # 19. the flat kernel against flat_reference on the wall-free scenes, at
    # a sweep of temporal depths and each storage type's default; against
    # flat_reference_blocked where its many tiles of plain PyTorch take
    # seconds, not minutes
    flat_err = 0.0
    flat_temporals = tuple(sorted({1, 2, 3, 4, 8, *fused_kernel.FLAT_TEMPORAL.values()}))
    for dtype in (np.float32, "bfloat16"):
        extra = [("5x3, smaller than one tile", LatticeConfig(nx=5, ny=3, dtype=dtype, accel=0.005)),
                 ("37x1001, ragged tiles", LatticeConfig(nx=37, ny=1001, dtype=dtype))]
        for name, cfg in [(name, cfg) for name, cfg, _ in scenes(dtype)] + extra:
            f0 = perturbed_state(cfg, rng)
            f0[6, cfg.nx // 2, 0] = 1e-6  # the forcing guard fails at one column-0 site
            t = state_tensor(f0, cfg.dtype, dev)
            blocked = cfg.sites < 100_000
            for n in (2, 8):
                want = fused_kernel.flat_reference(torch.stack([t, t]), cfg, n)
                for temporal in flat_temporals:
                    f2 = torch.stack([t, torch.full_like(t, float("nan"))])
                    label = f"flat {name} {dtype} n {n} T {temporal}"
                    flat_err = max(flat_err, bitwise(label, fused_kernel.flat_step(
                        f2, cfg, n, temporal=temporal), want))
                    if blocked:
                        bitwise(f"{label}: flat_reference_blocked", fused_kernel.flat_reference_blocked(
                            torch.stack([t, t]), cfg, n, temporal,
                            fused_kernel.flat_tile(t.dtype)), want)
            print(f"flat kernel vs flat_reference{', flat_reference_blocked' if blocked else ''}, "
                  f"{name} wall-free ({t.dtype}), 2 and 8 steps in one launch at T in "
                  f"{flat_temporals}: bitwise")
    # at full width: fast math within its bar, then FLAT_STEPS steps through
    # make_flat_step against the cuda backend
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    t = state_tensor(perturbed_state(cfg, rng), cfg.dtype, dev)
    steps, bar = fused_kernel.FAST_MATH_STEPS, fused_kernel.FAST_MATH_RTOL
    want = fused_kernel.flat_reference(torch.stack([t, t]), cfg, steps)[0]
    got = fused_kernel.make_flat_step(cfg, steps, fast_math=True)(torch.stack([t, t]))[0]
    flat_fast_rel = float(((got - want).abs() / want.abs()).max())
    if not flat_fast_rel <= bar:
        raise AssertionError(f"flat fast math after {steps} steps: max rel {flat_fast_rel!r} > {bar}")
    print(f"flat kernel, fast math, vs flat_reference (IEEE 1/rho) after {steps} steps in one "
          f"launch: max rel {flat_fast_rel!r} (bar {bar})")
    del want, got
    walls = geometry.empty(cfg.nx, cfg.ny)
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda")
    t = state_tensor(sim.state(), cfg.dtype, dev)
    want = sim.run(FLAT_STEPS).state()
    expect_counts("cuda backend on the empty lattice", {"f32-none": FLAT_STEPS})
    reset_counts()
    step = fused_kernel.make_flat_step(cfg, FLAT_CHUNK, walls=walls)
    f2 = torch.stack([t, t])
    for _ in range(FLAT_STEPS // FLAT_CHUNK):
        step(f2)
    torch.cuda.synchronize()
    flat_launches = expect_counts("flat path", {"flat": FLAT_STEPS // FLAT_CHUNK})["flat"]
    got = f2[0].cpu().numpy()
    if not (np.isfinite(got).all() and (got >= 0).all() and np.array_equal(got, want)):
        raise AssertionError(f"flat path after {FLAT_STEPS} steps != the cuda backend's state, "
                             f"max |diff| {float(np.abs(got - want).max())!r}")
    print(f"flat path: 800x4000 wall-free float32, {FLAT_STEPS} steps in {flat_launches} counted "
          f"launches of {FLAT_CHUNK} through make_flat_step, bitwise equal to "
          f"Simulation(backend=cuda) on geometry.empty after the same steps")
    del sim, f2, want, got

    # 20. the anatomy path itself, every launch counted, then times
    reset_counts()
    rc = anatomy.main(["--section", "all", "--steps", str(ANATOMY_STEPS)])
    if rc != 0:
        raise AssertionError(f"anatomy.main returned {rc}")
    counts = read_counts()
    roll_forms = {k: n for k, n in probes.ROLL_FORM_LAUNCHES.items() if n}
    wanted = {"copy-direct", "copy-staged", "roll_y-shared", "roll_y-shuffle", "align-axis0",
              "align-axis1", "roll_x-shared", "roll_x-global", "flat"}
    forms_wanted = {f"{kind}-{form}" for kind in ("roll_y", "roll_x") for form in probes.FORMS}
    if wanted - set(counts) or forms_wanted - set(roll_forms):
        raise AssertionError(f"the anatomy path launched no "
                             f"{sorted(wanted - set(counts) | forms_wanted - set(roll_forms))}: "
                             f"{counts}, by form {roll_forms}")
    print(f"anatomy path: --section all --steps {ANATOMY_STEPS} at 800x4000, launches {counts}, "
          f"the rolls' by form {roll_forms}")

    rates = rates_printer(cfg, bytes_per_site(np.float32))
    a = rand((9, cfg.nx, cfg.ny))
    b = torch.empty_like(a)
    copy = copy_rate(rates, a, b, "an 800x4000 float32 state (phase 20)")
    copy_plain_ms = event_ms(lambda: probes.copy_reference(a), 100)
    n_bytes = 2 * a.numel() * a.element_size()
    del a, b

    # the on-chip probes: one launch at the JAX probe's counts (a few
    # microseconds, so queued behind a spin: the host's launch rate would
    # set the pace), and the slope per roll or add between two counts
    n1 = 2000
    x = rand((anatomy.ROLL_ROWS, cfg.ny))
    roll_entry = roll_times("roll_y", x, 6, n1)

    x = rand((anatomy.ALIGN_ROWS, cfg.ny))
    align_ns = {}
    for axis in (0, 1):
        for offset in (0, 1, 2, 2, 1, 0):
            out = probes.align(x, offset, 0, axis=axis)
            dt = timed_slope(lambda n: probes.align(x, offset, n, axis=axis, out=out), n1, 2 * n1)
            key = f"axis{axis}-offset{offset}"
            print(f"alignment, {key}: {dt * 1e9!r} ns/add (slope {n1}/{2 * n1}, in turns)")
            align_ns[key] = min(align_ns.get(key, dt * 1e9), dt * 1e9)
    out = probes.align(x, 1, 0, axis=1)
    align_ms = queued_ms(lambda: probes.align(x, 1, 8, axis=1, out=out), 200)
    align_plain_ms = queued_ms(lambda: probes.align_reference(x, 1, 8, 1), 50)
    print(f"alignment, 8 adds at column offset 1 of (40, 4000): kernel {align_ms * 1e3!r} us, "
          f"plain version {align_plain_ms * 1e3!r} us")
    align_entry = {
        "ms": align_ms, "plain_ms": align_plain_ms,
        # the block read once, the output written once; 8 adds per element
        **bound((x.numel() + out.numel()) * 4, 8 * out.numel()),
        "ns_per_add": align_ns,
        # one 4-byte operand per element and add through L1, over the card's SMs
        "l1_bound_ns_per_add": anatomy.onchip_bound_s(out.numel() * 4) * 1e9,
    }

    rollx_entry = roll_times("roll_x", x, 8, n1)
    del x, out

    # the flat kernel beside the step kernel, in turns, per step
    def flat_and_step(cfg_):
        t_ = state_tensor(perturbed_state(cfg_, rng), cfg_.dtype, dev)
        f2_ = torch.stack([t_, t_])
        u_ = torch.empty_like(t_)
        flat_ = fused_kernel.make_flat_step(cfg_, FLAT_CHUNK)
        temporal = fused_kernel.FLAT_TEMPORAL[t_.dtype]
        info = fused_kernel.flat_info(t_.dtype)
        out_r, out_c = fused_kernel.flat_output(fused_kernel.flat_tile(t_.dtype), t_.dtype,
                                                temporal)
        print(f"flat kernel {cfg_.nx}x{cfg_.ny} {t_.dtype}: T {temporal}, tile {info['rows']}x"
              f"{info['width']} (output {out_r}x{out_c} at T steps), "
              f"{info['ctas_per_sm']} CTAs/SM, {info['registers']} "
              f"registers, {info['shared_bytes_per_cta']} shared B/CTA, {info['local_bytes']} B "
              f"local memory; passes {fused_kernel.flat_schedule(FLAT_CHUNK, temporal)}")

        def two_steps():
            fused_kernel.step(t_, u_, None, cfg_)
            fused_kernel.step(u_, t_, None, cfg_)

        r = rates_printer(cfg_, bytes_per_site(cfg_.dtype))
        label = f"{cfg_.nx}x{cfg_.ny} {t_.dtype}"
        best_ = {}
        names = {"step": "step kernel, wall-free, one launch per step",
                 "flat": f"flat kernel, {FLAT_CHUNK} steps per launch"}
        for which in ("step", "flat", "flat", "step"):
            # queued behind a spin: on a small lattice the host's launch rate,
            # not the card, would set the step kernel's pace
            ms = (queued_ms(two_steps, 200) / 2 if which == "step"
                  else queued_ms(lambda: flat_(f2_), 20) / FLAT_CHUNK)
            r(f"{label}, {names[which]} (CUDA events, queued behind a spin, in turns)", ms * 1e-3)
            best_[which] = min(best_.get(which, ms), ms)
        best_["info"] = {"temporal": temporal, **info}
        return best_, f2_

    per_step, f2 = flat_and_step(cfg)
    flat_ms = event_ms(lambda: fused_kernel.flat_step(f2, cfg, FLAT_CHUNK), 20)
    flat_plain_ms = event_ms(lambda: fused_kernel.flat_reference(f2, cfg, FLAT_CHUNK), 2)
    print(f"flat_reference, {FLAT_CHUNK} steps, its plain version: {flat_plain_ms!r} ms")
    state_bytes = f2[0].numel() * 4
    del f2
    small, _ = flat_and_step(LatticeConfig(nx=400, ny=2000, dtype="bfloat16"))
    per_step16, _ = flat_and_step(LatticeConfig(nx=800, ny=4000, dtype="bfloat16"))

    source = "latticeboltzmann_tpu_torch/csrc/lbm_probes.cu"
    return [
        {"name": f"lbm_copy_direct / lbm_copy_staged (best form: {copy['form']})",
         "route": "cuda", "source": source, "replaces": "scripts/anatomy.py:140",
         "launches": counts["copy-direct"] + counts["copy-staged"], "max_abs_err": err["copy"],
         "ms": copy["ms"], "plain_ms": copy_plain_ms, **bound(n_bytes, 0),
         "library_ms": copy["library_ms"], "forms_ms": copy["forms"]},
        {"name": "lbm_roll_y_shared (narrow, the default) / lbm_roll_y_cluster (wide: each "
                 "row across a thread-block cluster) / lbm_roll_y_shuffle (6 rolls by 1 of "
                 "(32, 4000))",
         "route": "cuda", "source": source, "replaces": "scripts/anatomy.py:192",
         "launches": counts["roll_y-shared"] + counts["roll_y-shuffle"],
         "launches_by_form": {f: roll_forms.get(f"roll_y-{f}", 0) for f in probes.FORMS},
         "max_abs_err": err["roll_y"], **roll_entry},
        {"name": "lbm_align (8 adds at column offset 1 of (40, 4000))",
         "route": "cuda", "source": source, "replaces": "scripts/anatomy.py:224",
         "launches": counts["align-axis0"] + counts["align-axis1"],
         "max_abs_err": err["align"], **align_entry},
        {"name": "lbm_roll_x_wide (16-byte vectors, the default) / lbm_roll_x_shared (narrow) / "
                 "lbm_roll_x_global (8 rolls by 1 of (40, 4000))",
         "route": "cuda", "source": source, "replaces": "scripts/anatomy.py:252",
         "launches": counts["roll_x-shared"] + counts["roll_x-global"],
         "launches_by_form": {f: roll_forms.get(f"roll_x-{f}", 0) for f in probes.FORMS},
         "max_abs_err": err["roll_x"], **rollx_entry},
        {"name": f"lbm_flat_steps<float> ({FLAT_CHUNK} wall-free steps per launch, "
                 f"T={per_step['info']['temporal']}, 800x4000)",
         "route": "cuda", "source": "latticeboltzmann_tpu_torch/csrc/lbm_flat_step.cu",
         "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1845",
         "launches": counts["flat"], "launches_full_width_check": flat_launches,
         "max_abs_err": flat_err, "max_rel_err_fast_math": flat_fast_rel,
         "ms": flat_ms, "plain_ms": flat_plain_ms,
         # the function: parity 0 read once, both parities written once; every
         # step's operations
         **bound(3 * state_bytes, FLAT_CHUNK * F32_OPS_PER_SITE * cfg.sites),
         # and what FLAT_CHUNK steps move when each goes through device memory
         "per_step_traffic_bound_ms": FLAT_CHUNK * 2 * state_bytes / PEAK_BYTES_PER_S * 1e3,
         **per_step["info"], "bf16_info": per_step16["info"],
         "us_per_step": per_step["flat"] * 1e3, "step_kernel_us_per_step": per_step["step"] * 1e3,
         "bf16_us_per_step": per_step16["flat"] * 1e3,
         "bf16_step_kernel_us_per_step": per_step16["step"] * 1e3,
         "bf16_400x2000_us_per_step": small["flat"] * 1e3,
         "bf16_400x2000_step_kernel_us_per_step": small["step"] * 1e3},
    ]


def panels_phase():
    """Phase 21: one float32 step at 4000x16000, the shape the TPU kernel
    needed lane panels for, spec and wall-free variants, bitwise against
    step_reference."""
    from latticeboltzmann_tpu_torch import LatticeConfig, geometry, initial_state
    from latticeboltzmann_tpu_torch.ops import fused_kernel

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    cfg = LatticeConfig(nx=4000, ny=16000, dtype=np.float32)
    spec = geometry.infer_spec(geometry.reference_barrier(cfg.nx, cfg.ny))
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    a = torch.as_tensor(initial_state(cfg), device=dev)
    for s in range(9):  # rest equilibrium times (1 + 5% noise), plane by plane
        a[s].mul_(torch.rand(a[s].shape, generator=gen, device=dev).mul_(0.1).add_(0.95))
    a[6, cfg.nx // 2, 0] = 1e-6  # the forcing guard fails at one column-0 site
    b = torch.empty_like(a)
    for kind, geom in (("spec", spec), ("wall-free", None)):
        want = reference(a, geom, cfg)
        for form in fused_kernel.FORMS:
            before = fused_kernel.FORM_LAUNCHES[form]
            b.fill_(float("nan"))
            fused_kernel.step(a, b, geom, cfg, form=form)
            bitwise(f"4000x16000 float32 {kind}, {form} form", b, want)
            print(f"kernel vs step_reference 4000x16000 (float32, {kind}), {form} form, 1 step, "
                  f"{fused_kernel.FORM_LAUNCHES[form] - before} launch: bitwise")
        del want
    del a, b
    torch.cuda.empty_cache()


def probed_series(sim, every, probes):
    """run() of `every` steps, then probe_values, PROBED_STEPS // every
    times: the series run_probed must equal."""
    return np.stack([sim.run(every).probe_values(probes) for _ in range(PROBED_STEPS // every)])


def probed_phases(f32_main):
    """Phase 25: run_probed on the kernel backends from phase 4's
    developed state (f32_main; rounded to bf16, or widened to float64,
    as the backend stores it), bitwise against run() with probe_values
    between chunks and against an unprobed run, its launches counted;
    then its cost per step beside run()'s."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.models import engine
    from latticeboltzmann_tpu_torch.parallel import sharded
    from latticeboltzmann_tpu_torch.scripts.numerics_tiers import PROBES

    torch.cuda.empty_cache()
    walls = geometry.reference_barrier(800, 4000)
    # the two sharded cases over virtual shards of the one card; main()
    # restores the registered defaults after this phase
    mesh = sharded.make_mesh(devices=["cuda"] * VIRTUAL_SHARDS)
    engine.register_backend("sharded-cuda-rdma", sharded.make_cuda_backend(mesh, rdma=True))
    engine.register_backend("sharded-cuda-ds64", sharded.make_cuda_ds_backend(mesh))
    form = {"wide": PROBED_STEPS * VIRTUAL_SHARDS}
    cases = (
        # (label, backend, dtype, launches of one run, form, the series it must also equal)
        ("cuda f32", "cuda", np.float32, {"f32-spec": PROBED_STEPS}, "wide", None),
        ("cuda bf16", "cuda", "bfloat16", {"bf16-spec": PROBED_STEPS}, "wide", None),
        # passes of the temporal form: every `every` steps one advance
        ("cuda-ds64", "cuda-ds64", np.float64,
         lambda every: {"ds-temporal": PROBED_STEPS // every * ds_passes(every)}, None, None),
        (f"sharded-cuda-rdma over {VIRTUAL_SHARDS} virtual shards", "sharded-cuda-rdma",
         np.float32, {"rdma-f32-spec": PROBED_STEPS * VIRTUAL_SHARDS}, form, "cuda f32"),
        # passes of the ext-halo temporal form per sample, one launch per
        # shard and pass
        (f"sharded-cuda-ds64 over {VIRTUAL_SHARDS} virtual shards", "sharded-cuda-ds64",
         np.float64, lambda every: {"ds-ext-temporal": PROBED_STEPS // every * ds_passes(every)
                                    * VIRTUAL_SHARDS}, None, "cuda-ds64"),
    )
    series_of = {}
    for label, backend, dtype, want, form_want, also in cases:
        cfg = LatticeConfig(nx=800, ny=4000, dtype=dtype)
        f0 = f32_main.astype(np.float64) if dtype == np.float64 else f32_main

        def fresh():
            return Simulation(cfg, walls, backend=backend, f0=f0, allow_experimental=True)

        final = fresh().run(PROBED_STEPS).state()
        for every in PROBED_EVERY:
            sim = fresh()
            reset_counts()
            got = sim.run_probed(PROBED_STEPS, PROBES, every=every)
            counts = expect_counts(f"run_probed, {label}, every {every}",
                                   want(every) if callable(want) else want, form_want)
            if got.shape != (PROBED_STEPS // every, len(PROBES), 3) or not np.isfinite(got).all():
                raise AssertionError(f"{label}, every {every}: series {got.shape}, finite "
                                     f"{np.isfinite(got).all()}")
            if sim.steps_done != PROBED_STEPS:
                raise AssertionError(f"{label}: steps_done {sim.steps_done}")
            want_series = probed_series(fresh(), every, PROBES)
            np.testing.assert_array_equal(got, want_series,
                                          err_msg=f"{label}, every {every}: run_probed "
                                                  "!= run() + probe_values")
            np.testing.assert_array_equal(sim.state(), final,
                                          err_msg=f"{label}, every {every}: probed state "
                                                  "!= unprobed state")
            if also is not None:
                np.testing.assert_array_equal(got, series_of[(also, every)],
                                              err_msg=f"{label} != {also}, every {every}")
            series_of[(label, every)] = got
            print(f"run_probed {label}, every {every}: {PROBED_STEPS} steps, series "
                  f"{got.shape} {got.dtype} bitwise equal to run() + probe_values between "
                  f"chunks{f' and to {also}' if also else ''}; final state bitwise equal "
                  f"to an unprobed run's; launches {counts}; last sample {got[-1].tolist()}")

    # the gather's cost: host clock around run_probed and run() (each ends
    # in a synchronize), in turns
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    sim = Simulation(cfg, walls, backend="cuda")
    sim.run(WARMUP)
    n = PROBED_TIMED_STEPS
    for every in (1, 8):
        fns = {"run()": lambda: sim.run(n),
               f"run_probed(every={every})": lambda e=every: sim.run_probed(n, PROBES, every=e)}
        best = {}
        for label in list(fns) + list(reversed(fns)):
            t0 = time.perf_counter()
            fns[label]()
            us = (time.perf_counter() - t0) / n * 1e6
            best[label] = min(best.get(label, us), us)
            print(f"probed path timing, 800x4000 f32 cuda, {label}: {us!r} us/step over {n} "
                  f"steps (host clock, in turns)")
        extra = best[f"run_probed(every={every})"] - best["run()"]
        print(f"run_probed(every={every}) costs {extra!r} us/step over run() (best of two): "
              f"{extra * every!r} us per sample of {len(PROBES)} probes")


def suite_phase(card):
    """Phase 26: every bench_suite row at its quick length, each sane,
    the launches of the kernel routes the rows take counted."""
    from latticeboltzmann_tpu_torch import bench_suite

    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    rows = bench_suite.run_rows(bench_suite.CONFIGS, bench_suite.QUICK_STEPS, card,
                                emit=lambda line: print(f"bench_suite row: {line}", flush=True))
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"bench_suite: {len(rows)} rows at {bench_suite.QUICK_STEPS} steps in {wall!r} s; launches {counts}")
    insane = [r["config"] for r in rows if not r["sane"]]
    if len(rows) != len(bench_suite.CONFIGS) or insane:
        raise AssertionError(f"bench_suite rows not sane: {insane}")
    # the rows' kernel routes: f32 and bf16 single-chip, the ext-halo form
    # (sharded-cuda), the ds kernel's temporal form (cuda-ds64) and its
    # ext-halo temporal form (sharded-cuda-ds64, passes of 4); a key ending
    # in "-" names a family of variants, any other one kernel
    for route, prefix in (("f32", "f32-"), ("bf16", "bf16-"), ("ext-halo", "ext-f32-"),
                          ("ds temporal", "ds-temporal"),
                          ("ds ext-halo temporal", "ds-ext-temporal")):
        if not any((k.startswith(prefix) if prefix.endswith("-") else k == prefix) and n
                   for k, n in counts.items()):
            raise AssertionError(f"bench_suite launched no {route} kernel: {counts}")
    torch.cuda.empty_cache()


def validate_ds_phase():
    """Phase 27: scripts/validate_ds.py at its default size on the card."""
    from latticeboltzmann_tpu_torch.scripts import validate_ds

    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel

    reset_counts()
    out = validate_ds.validate(400, 2000, 2000, "cuda-ds64", "cuda")
    counts = read_counts()
    print(f"validate_ds: {json.dumps(out)}; launches {counts}, "
          f"{fused_ds_kernel.TEMPORAL_STEPS} steps in the temporal form's passes")
    if (not out["reynolds_pass"] or counts != {"ds-temporal": ds_passes(2000)}
            or fused_ds_kernel.TEMPORAL_STEPS != 2000):
        raise AssertionError(f"validate_ds failed: {out}, launches {counts}")


# the kernels-line entry of each kernel the CLI phase launches: the start
# of its name, or (exact) its whole name
CLI_ENTRIES = {"f32": ("lbm_stream_collide_wide<float,", False),
               "bf16": ("lbm_stream_collide_wide<__nv_bfloat16,", False),
               "ds": ("lbm_ds_temporal_steps<", False),
               "rdma": ("lbm_stream_collide_rdma_wide<", False)}


def add_cli_launches(entries, cli_launches, n_cards):
    """Records phase 28's launches of each kernel beside its entry's
    launches, as cli_launches; launches stays the count of the entry's
    own main path. The CLI's rdma runs are a ring of n_cards cards
    (cli_cards), where the entry's main path is 4 virtual shards."""
    for kernel, (name, exact) in CLI_ENTRIES.items():
        hits = [e for e in entries
                if (e["name"] == name if exact else e["name"].startswith(name))]
        if len(hits) != 1:
            raise AssertionError(f"kernels line: {len(hits)} entries for {name!r}")
        hits[0]["cli_launches"] = cli_launches[kernel]
        if kernel == "rdma":
            hits[0]["cli_cards"] = n_cards


# the CLI phase (28): the lattice; the f32 main path's steps, its snapshot
# and checkpoint interval (also the steps of its resume), its stats and
# probe intervals; each other backend class's steps (and its resume's)
CLI_NX, CLI_NY = 800, 4000
CLI_STEPS = 2000
CLI_EVERY = 1000
CLI_STATS_EVERY = 500
CLI_PROBE_EVERY = 100
CLI_WARMUP = 8
CLI_OTHER_STEPS = 500


def cli_call(label, argv):
    """latticeboltzmann_tpu_torch.cli.main(argv) in this process, its
    stdout echoed line by line under `label`: (exit code, stderr)."""
    import contextlib
    import io

    from latticeboltzmann_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        print(f"  cli {label}| {line}")
    print(f"cli {label}: exit {rc} in {wall!r} s; stderr {err.getvalue().strip()!r}")
    return rc, err.getvalue()


def snapshot_ok(path, nx, ny):
    """A |u|^2 snapshot CSV of nx rows of ny values, every one finite
    ('%.10f' writes non-finite values as nan or inf)."""
    data = path.read_bytes()
    lines = data.splitlines()
    if len(lines) != nx or lines[0].count(b", ") != ny - 1 or b"nan" in data or b"inf" in data:
        raise AssertionError(f"{path}: {len(lines)} rows, {lines[0].count(b', ') + 1} columns, "
                             f"non-finite {b'nan' in data or b'inf' in data}")


def cli_phase(tmp):
    """Phase 28: the CLI (python -m latticeboltzmann_tpu_torch) on the
    card at 800x4000, in process through cli.main: (a) the f32 main path
    with snapshots, checkpoints, probes, a profiler trace and --debug-nans,
    resumed, against an unbroken CLI run, a Simulation run and the trace;
    (b) bf16, cuda-ds64 and sharded-cuda-rdma over the visible cards,
    resumed against an unbroken run; (c) --debug-nans on a planted NaN;
    (d) the refusals, and the host IO times of a snapshot (both paths of
    utils/native.py's CSV writer) and a checkpoint. Writes under `tmp`;
    returns {kernel: launches} of the CLI runs."""
    import contextlib
    import shutil

    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.scripts.numerics_tiers import PROBES
    from latticeboltzmann_tpu_torch.utils import checkpoint, native, viz

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    nx, ny = CLI_NX, CLI_NY
    scene = ["--nx", nx, "--ny", ny, "--geometry", "reference"]
    launched = {"f32": 0, "bf16": 0, "ds": 0, "rdma": 0}

    def counted(label, argv, want, form, kernel, rc_want=0):
        reset_counts()
        rc, err = cli_call(label, argv)
        if (rc != 0) != (rc_want != 0):
            raise AssertionError(f"cli {label}: exit {rc}: {err}")
        counts = expect_counts(f"cli {label}", want, form)
        launched[kernel] += sum(counts.values())
        return err

    # (a) the main path: cuda f32, every event, a trace and --debug-nans
    a = tmp / "f32"
    probe_args = [x for i, j in PROBES for x in ("--probe", f"{i},{j}")]
    counted("f32", scene + ["--backend", "cuda", "--precision", "f32", "--steps", CLI_STEPS,
                            "--warmup", CLI_WARMUP, "--print-stats-every", CLI_STATS_EVERY,
                            "--save-lattice-every", CLI_EVERY, "--snapshot-dir", a / "data",
                            "--checkpoint-every", CLI_EVERY, "--checkpoint-dir", a / "ck",
                            *probe_args, "--probe-every", CLI_PROBE_EVERY,
                            "--probe-out", a / "probes.csv", "--profile-dir", a / "prof",
                            "--debug-nans"],
            {"f32-spec": CLI_STEPS + CLI_WARMUP}, "wide", "f32")
    end = CLI_STEPS + CLI_EVERY
    counted("f32 resumed", ["--resume", "latest", "--checkpoint-dir", a / "ck", "--backend", "cuda",
                            "--steps", CLI_EVERY, "--checkpoint-every", CLI_EVERY,
                            "--warmup", CLI_WARMUP, "--print-stats-every", CLI_STATS_EVERY],
            {"f32-spec": CLI_EVERY + CLI_WARMUP}, "wide", "f32")
    counted("f32 unbroken", scene + ["--backend", "cuda", "--steps", end, "--warmup", CLI_WARMUP,
                                     "--checkpoint-every", end, "--checkpoint-dir", a / "ck1",
                                     "--print-stats-every", CLI_EVERY],
            {"f32-spec": end + CLI_WARMUP}, "wide", "f32")
    resumed = (a / "ck" / f"{end}.lbmckpt" / "f.raw").read_bytes()
    if resumed != (a / "ck1" / f"{end}.lbmckpt" / "f.raw").read_bytes():
        raise AssertionError(f"cli f32: the resumed {end}.lbmckpt/f.raw differs from the "
                             "unbroken run's")
    print(f"cli f32: {CLI_STEPS} steps, then --resume latest for {CLI_EVERY}: "
          f"{end}.lbmckpt/f.raw ({len(resumed)} B) byte-equal to an unbroken {end}-step CLI run's")
    # the snapshots and the probe series against a Simulation from the same start
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float32)
    walls = geometry.reference_barrier(nx, ny)
    sim = Simulation(cfg, walls, backend="cuda")
    series = []
    for k in range(1, CLI_STEPS // CLI_PROBE_EVERY + 1):
        series.append(sim.run(CLI_PROBE_EVERY).probe_values(PROBES))
        step = k * CLI_PROBE_EVERY
        if step % CLI_EVERY == 0:
            viz.write_snapshot_csv(tmp / "want.csv", sim.speed_squared())
            if (a / "data" / f"{step}.csv").read_bytes() != (tmp / "want.csv").read_bytes():
                raise AssertionError(f"cli f32: data/{step}.csv differs from "
                                     "write_snapshot_csv(Simulation.run().speed_squared())")
    rows = [line.split(",") for line in (a / "probes.csv").read_text().splitlines()]
    if rows[0] != ["step", "i", "j", "rho", "u_x", "u_y"] or len(rows) != 1 + 3 * len(series):
        raise AssertionError(f"cli f32: probes.csv header {rows[0]}, {len(rows)} lines")
    got = np.array([[float(v) for v in r[3:]] for r in rows[1:]]).reshape(len(series), len(PROBES), 3)
    sites = np.array([[int(v) for v in r[:3]] for r in rows[1:]]).reshape(len(series), len(PROBES), 3)
    want = np.stack(series).astype(np.float64)
    np.testing.assert_array_equal(got, want, err_msg="cli f32: probes.csv != run() + probe_values")
    steps = np.arange(CLI_PROBE_EVERY, CLI_STEPS + 1, CLI_PROBE_EVERY)
    np.testing.assert_array_equal(sites[:, :, 0], np.repeat(steps[:, None], len(PROBES), 1))
    np.testing.assert_array_equal(sites[:, :, 1:], np.broadcast_to(PROBES, sites[:, :, 1:].shape))
    print(f"cli f32: data/{CLI_EVERY}.csv and data/{CLI_STEPS}.csv byte-equal to "
          "write_snapshot_csv of Simulation(backend='cuda').run().speed_squared(); probes.csv "
          f"bitwise equal to run({CLI_PROBE_EVERY}) + probe_values x {len(series)}; last row "
          f"{rows[-1]}")
    del sim
    # the trace: entered before the warmup, closed after the last chunk's events
    traces = list((a / "prof").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"cli f32: traces {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    wide = [e for e in kernels if "lbm_stream_collide_wide" in e.get("name", "")]
    if len(wide) != CLI_STEPS + CLI_WARMUP:
        raise AssertionError(f"cli f32: the trace names lbm_stream_collide_wide {len(wide)} "
                             f"times, expected {CLI_STEPS + CLI_WARMUP}; kernels "
                             f"{sorted({e.get('name') for e in kernels})[:8]}")
    chunks = CLI_STEPS // CLI_PROBE_EVERY
    spans = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    if spans.count("lbm_warmup") != 1 or spans.count("lbm_run") != chunks:
        raise AssertionError(f"cli f32: the trace holds {spans.count('lbm_warmup')} lbm_warmup "
                             f"and {spans.count('lbm_run')} lbm_run spans, expected 1 and "
                             f"{chunks}")
    busy_us = sum(e["dur"] for e in kernels)
    print(f"cli f32 trace ({pathlib.Path(traces[0]).stat().st_size} B): the window from before "
          f"the warmup to after the last chunk's events names lbm_stream_collide_wide "
          f"{len(wide)} times (= {CLI_WARMUP} warmup + {CLI_STEPS} steps), {len(kernels)} kernels "
          f"in all; the wide kernel {sum(e['dur'] for e in wide) / len(wide)!r}"
          f" us a launch under the profiler, all kernels {busy_us!r} us; name "
          f"{wide[0]['name']!r}; spans: 1 lbm_warmup, {chunks} lbm_run (one a chunk)")
    shutil.rmtree(a / "prof")
    shutil.rmtree(a / "ck1")

    # (b) the other backend classes: a run, its resume, an unbroken run
    n_cards = torch.cuda.device_count()
    others = (
        ("bf16", ["--backend", "cuda", "--precision", "bf16"], {"bf16-spec": 1}, "wide", "bf16"),
        # the warmup and each chunk are one advance: passes of the temporal form
        ("cuda-ds64", ["--backend", "cuda-ds64", "--precision", "f64"], {"ds-temporal": ds_passes},
         None, "ds"),
        (f"sharded-cuda-rdma over {n_cards} card(s)",
         ["--backend", "sharded-cuda-rdma", "--precision", "f32"],
         {"rdma-f32-spec": n_cards}, "wide", "rdma"),
    )
    n, end = CLI_OTHER_STEPS, 2 * CLI_OTHER_STEPS
    for label, args, per_step, form, kernel in others:
        d = tmp / kernel

        def want(steps):
            # launches per step, or of one advance (a function of its steps)
            counts = {k: v(steps) + v(CLI_WARMUP) if callable(v) else v * (steps + CLI_WARMUP)
                      for k, v in per_step.items()}
            return counts, (None if form is None else {form: sum(counts.values())})

        common = ["--warmup", CLI_WARMUP, "--print-stats-every", 0, "--debug-nans"]
        counted(label, scene + args + common + [
            "--steps", n, "--save-lattice-every", n, "--snapshot-dir", d / "data",
            "--checkpoint-every", n, "--checkpoint-dir", d / "ck"], *want(n), kernel)
        counted(f"{label} resumed", args + common + [
            "--resume", "latest", "--steps", n, "--save-lattice-every", n,
            "--snapshot-dir", d / "data", "--checkpoint-every", n, "--checkpoint-dir", d / "ck"],
            *want(n), kernel)
        counted(f"{label} unbroken", scene + args + common + [
            "--steps", end, "--checkpoint-every", end, "--checkpoint-dir", d / "ck1"],
            *want(end), kernel)
        for step in (n, end):
            snapshot_ok(d / "data" / f"{step}.csv", nx, ny)
        _, f_res, _, cfg_res = checkpoint.load(d / "ck" / f"{end}.lbmckpt")
        _, f_one, _, _ = checkpoint.load(d / "ck1" / f"{end}.lbmckpt")
        if np.array_equal(f_res, f_one):
            bar = "bitwise"
        elif kernel == "ds":
            np.testing.assert_allclose(f_res, f_one, rtol=DS_RTOL, atol=0,
                                       err_msg=f"cli {label}: resumed != unbroken")
            bar = (f"within DS_RTOL {DS_RTOL} (max rel "
                   f"{float(np.max(np.abs(f_res - f_one) / np.abs(f_one)))!r}; not bitwise)")
        else:
            raise AssertionError(f"cli {label}: the resumed state differs from the unbroken run's")
        print(f"cli {label}: {n} steps + --resume latest {n} against an unbroken {end}: {bar}; "
              f"checkpoint dtype {checkpoint.dtype_name(cfg_res.dtype)}; snapshots {n}, {end} "
              "finite")
        shutil.rmtree(d)

    # (c) --debug-nans: a NaN planted in one site of a checkpoint
    nan_ck = tmp / "nan"
    src = a / "ck" / f"{CLI_STEPS}.lbmckpt"
    dst = nan_ck / src.name
    dst.mkdir(parents=True)
    for name in ("meta.json", "walls.raw"):
        (dst / name).write_bytes((src / name).read_bytes())
    f_nan = np.fromfile(src / "f.raw", dtype=np.float32)
    site = (5, nx // 2, ny // 2)
    f_nan[np.ravel_multi_index(site, (9, nx, ny))] = np.nan
    f_nan.tofile(dst / "f.raw")
    first = CLI_STEPS + CLI_STATS_EVERY
    err = counted("f32 planted NaN", ["--resume", "latest", "--checkpoint-dir", nan_ck,
                                      "--backend", "cuda", "--steps", CLI_EVERY,
                                      "--warmup", CLI_WARMUP, "--print-stats-every",
                                      CLI_STATS_EVERY, "--checkpoint-every", CLI_STATS_EVERY,
                                      "--debug-nans"],
                  {"f32-spec": CLI_STATS_EVERY + CLI_WARMUP}, "wide", "f32", rc_want=1)
    if f"after step {first}" not in err or (nan_ck / f"{first}.lbmckpt").exists():
        raise AssertionError(f"cli --debug-nans: {err!r}")
    print(f"cli --debug-nans: a NaN planted at site {site} of {src.name} stops the resumed run "
          f"after its first chunk (step {first}, {CLI_STATS_EVERY + CLI_WARMUP} launches, no "
          "checkpoint written): exit 1")

    # (d) refusals before any step, the movie, and host IO times
    refusals = [("orbax", ["--checkpoint-format", "orbax", "--checkpoint-every", CLI_EVERY])]
    try:
        import matplotlib  # noqa: F401
        movie_error = None
    except ImportError as e:
        movie_error = f"{type(e).__name__}: {e}"
        refusals.append(("movie", ["--movie", tmp / "flow.gif", "--save-lattice-every", CLI_EVERY]))
    for label, args in refusals:
        counted(f"refusal {label}", scene + ["--backend", "cuda", "--steps", CLI_STEPS] + args,
                {}, None, "f32", rc_want=2)
    if movie_error is None:
        t0 = time.perf_counter()
        out = viz.render_movie(a / "data", tmp / "flow.gif")
        print(f"cli --movie: {out.stat().st_size} B gif of "
              f"{len(list((a / 'data').glob('*.csv')))} frames at {nx}x{ny} in "
              f"{time.perf_counter() - t0!r} s")
    else:
        print(f"cli --movie: not run: matplotlib does not import on this machine ({movie_error}); "
              "the CLI refused it with exit 2 before any step (0 launches); the movie is tested "
              "on the CPU (tests/test_torch_utils.py, tests/test_torch_cli.py)")
    step, f_io, w_io, cfg_io = checkpoint.load(a / "ck" / f"{CLI_STEPS}.lbmckpt")
    usq = Simulation(cfg_io, w_io, backend="cuda", f0=f_io).speed_squared()
    for path_name, ctx in (("native", contextlib.nullcontext), ("numpy", native.numpy_only)):
        with ctx():
            if path_name == "native" and not native.available():
                raise AssertionError("utils/native.py: the C++ library did not build (g++)")
            t0 = time.perf_counter()
            viz.write_snapshot_csv(tmp / f"io_{path_name}.csv", usq)
            t_csv = time.perf_counter() - t0
        csv_mb = (tmp / f"io_{path_name}.csv").stat().st_size / 1e6
        print(f"host IO at {nx}x{ny}, {path_name} CSV writer: snapshot CSV {csv_mb!r} MB in "
              f"{t_csv!r} s ({csv_mb / t_csv!r} MB/s) (into the page cache)")
    t0 = time.perf_counter()
    d = checkpoint.save(tmp / "io_ck", step, f_io, w_io, cfg_io)
    t_save = time.perf_counter() - t0
    ck_mb = sum(p.stat().st_size for p in d.iterdir()) / 1e6
    t0 = time.perf_counter()
    back = checkpoint.load(d)[1]
    t_load = time.perf_counter() - t0
    if not np.array_equal(back, f_io):
        raise AssertionError("checkpoint round trip")
    print(f"host IO at {nx}x{ny}: checkpoint save {ck_mb!r} MB in {t_save!r} s "
          f"({ck_mb / t_save!r} MB/s), load {t_load!r} s ({ck_mb / t_load!r} MB/s) "
          "(ndarray.tofile / np.fromfile, into and from the page cache)")
    if (tmp / "io_native.csv").read_bytes() != (tmp / "io_numpy.csv").read_bytes():
        raise AssertionError("the native and NumPy CSV writers differ")
    print(f"cli phase (28): {time.perf_counter() - t_phase!r} s; launches {launched}")
    torch.cuda.empty_cache()
    return launched


# the temporal form (phase 29): the depths timed beside the card's deepest
# pass (1: one step-kernel launch per step), the steps of a timed run at
# 800x4000 (rounded up to a multiple of each depth), and the first part of
# the split run, no multiple of any depth above 1
TEMPORAL_DEPTHS = (1, 2, 3, 4, 6, 8)
TEMPORAL_TIMED_STEPS = 480
TEMPORAL_SPLIT = (1009, 491)


def temporal_bitwise(name, cfg, geom, f, blocked):
    """One pass of L steps of the temporal form for every L the card's
    tile takes, from f, bitwise against the chain of step_reference (L
    steps) and, where blocked(L), against temporal_reference_blocked at
    the card's tile. Returns max |diff| (0.0)."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

    info = fk.temporal_info(f.dtype)
    tile, most = fk.FlatTile(info["rows"], info["width"]), info["max_steps"]
    ref, err = f, 0.0
    for steps in range(1, most + 1):
        ref = reference(ref, geom, cfg)
        label = f"temporal {name} ({f.dtype}) L {steps}"
        got = fk.temporal_step(f, torch.full_like(f, float("nan")), geom, cfg, steps)
        err = max(err, bitwise(label, got, ref))
        if blocked(steps):
            bitwise(f"{label}: temporal_reference_blocked",
                    fk.temporal_reference_blocked(f, geom, cfg, steps, tile), ref)
    return err


def session_times(sess, n):
    """(ms per step by CUDA events around sess.advance(n): the pace with
    the host's launches, card ms per step queued behind a spin, host
    enqueue ms per step)."""
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    sess.advance(n)
    e1.record()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n, queued_ms(lambda: sess.advance(n), 1) / n, enqueue * 1e3 / n


def temporal_times(cfg, walls, geom_kind, f, depths, target, rates, label):
    """us/step of Session(temporal=T) over `depths` with the walls as a
    plane or a spec (geom_kind), in turns (the list,
    then reversed), each run `target` steps rounded up to a multiple of T:
    by CUDA events (the pace), queued behind a spin (the card's time) and
    the host's enqueue. Returns {T: (best pace ms, best card ms, best
    enqueue ms)} per step."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

    spec = geometry_spec(walls) if geom_kind == "spec" else None
    sessions = {}
    for depth in depths:
        sess = fk.Session(cfg, walls, device="cuda", wall_spec=spec, temporal=depth)
        if (geom_kind == "plane") != torch.is_tensor(sess.geom):
            raise AssertionError(f"{label}: the {geom_kind} variant runs {type(sess.geom)}")
        sess.load(f)
        sessions[depth] = sess
    best = {}
    for depth in list(depths) + list(reversed(depths)):
        n = -(-target // depth) * depth
        pace, card, enq = session_times(sessions[depth], n)
        rates(f"{label} {geom_kind}, T={depth} ({n} steps, {n // depth} launches; in turns): "
              f"card {card * 1e3!r} us/step queued behind a spin, host enqueue "
              f"{enq * 1e3!r} us/step; CUDA events", pace * 1e-3)
        old = best.get(depth, (float("inf"),) * 3)
        best[depth] = tuple(min(a, b) for a, b in zip(old, (pace, card, enq)))
    return best


def geometry_spec(walls):
    from latticeboltzmann_tpu_torch import geometry

    spec = geometry.infer_spec(walls)
    if spec is None:
        raise AssertionError("infer_spec found no closed form")
    return spec


def temporal_phases(f32_main, bf16_main):
    """Phase 29: the temporal form (csrc/lbm_temporal_step.cu), passes of
    L steps with walls. (a) Its tile, registers and spills; one pass of L
    steps for every L the card's tile takes, f32 and bf16, bitwise
    against the chain of step_reference and, below 100,000 sites, against
    temporal_reference_blocked: phase 3's scenes (plane, wall-free and,
    where infer_spec finds one, the spec), the reference barrier at
    800x4000 as plane and spec, slip_scene at 24x40 and 800x4000, a 5x8
    lattice smaller than one tile and a 37x1000 one ragged in both axes,
    the forcing guard failing at one column-0 site; fast math within
    FAST_MATH_RTOL. (b) us/step of Session(temporal=T) at 800x4000 for T
    in TEMPORAL_DEPTHS and the card's deepest pass, f32 and bf16, spec
    and plane, in turns (pace by CUDA events, the card's time queued
    behind a spin, the host's enqueue), then bf16 at 4000x16000 and f32 at
    400x2000 (spec). (c) The main path: Simulation(reference_barrier(800,
    4000), backend="cuda", temporal=T) at the fastest T >= 2 of (b), f32
    and bf16: WARMUP + MAIN_STEPS steps bitwise equal to phase 4's and
    phase 13's states (f32_main, bf16_main), exactly (WARMUP + MAIN_STEPS)
    // T launches of T steps and one of the rest, no one-step launch;
    run_probed at every = 1, 8 and 3 bitwise equal to temporal=None's
    series and state; run(a) + run(b), a no multiple of T, bitwise equal
    to run(a + b). Returns the kernels line's entry."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry, initial_state
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
    from latticeboltzmann_tpu_torch.scripts import anatomy
    from latticeboltzmann_tpu_torch.scripts.numerics_tiers import PROBES
    from latticeboltzmann_tpu_torch.utils.interop import bytes_per_site, state_tensor

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 29)
    bf16 = "bfloat16"
    dtypes = {np.float32: torch.float32, bf16: torch.bfloat16}

    # 29a. the tile, then bitwise at every depth the tile takes
    info = {}
    for name, st in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for kind in ("none", "plane", "spec"):
            i = info[f"{name}-{kind}"] = fk.temporal_info(st, kind)
            print(f"temporal kernel lbm_temporal_steps<{name}, {kind}>: tile {i['rows']}x"
                  f"{i['width']} sites, {i['ctas_per_sm']} CTAs/SM, {i['registers']} registers, "
                  f"{i['local_bytes']} B local memory (stack and spills), "
                  f"{i['shared_bytes_per_cta']} shared B/CTA; deepest pass "
                  f"{i['max_steps']} steps")
    err = 0.0
    for dtype in (np.float32, bf16):
        cases = []
        for name, cfg, w in scenes(dtype):
            cases += [(name, cfg, None), (f"{name} plane", cfg, w.astype(np.uint8))]
            if w.any() and geometry.infer_spec(w) is not None:
                cases.append((f"{name} spec", cfg, geometry.infer_spec(w)))
        for nx, ny in ((24, 40), (800, 4000)):
            walls, slip_x, slip_y = slip_scene(nx, ny)
            cases.append((f"{nx}x{ny} slip_x top row + slip_y block",
                          LatticeConfig(nx=nx, ny=ny, dtype=dtype),
                          fk.class_plane(walls, slip_x, slip_y)))
        cases.append(("5x8, smaller than one tile", LatticeConfig(nx=5, ny=8, dtype=dtype,
                                                                  accel=0.005),
                      geometry.channel(5, 8).astype(np.uint8)))
        w = geometry.channel(37, 1000)
        w[10:20, 300:305] = True
        cases.append(("37x1000, ragged tiles", LatticeConfig(nx=37, ny=1000, dtype=dtype),
                      w.astype(np.uint8)))
        for name, cfg, geom in cases:
            f0 = perturbed_state(cfg, rng)
            f0[6, cfg.nx // 2, 0] = 1e-6  # the forcing guard fails at one column-0 site
            f = state_tensor(f0, cfg.dtype, dev)
            # the blocked plain version's tiles are many small PyTorch calls,
            # and the CPU tests hold it at L 1-4: here L 1-3 and the deepest
            # on lattices of one or a few tiles, 1-2 on the ragged one, none
            # at full width
            most = fk.temporal_info(f.dtype)["max_steps"]
            depths = ("L 1-3 and the deepest" if cfg.sites < 2000 else
                      "L 1-2" if cfg.sites < 100_000 else None)
            err = max(err, temporal_bitwise(
                name, cfg, on_card(geom, dev), f,
                lambda L: (cfg.sites < 2000 and (L <= 3 or L == most))
                or (cfg.sites < 100_000 and L <= 2)))
            kind = "wall-free" if geom is None else ("spec" if isinstance(geom, tuple) else "plane")
            print(f"temporal kernel vs step_reference, {name} ({f.dtype}, {kind}), one pass at "
                  f"every L in 1...{most}: bitwise"
                  + (f"; vs temporal_reference_blocked at {depths}: bitwise" if depths else ""))
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    walls = geometry.reference_barrier(800, 4000)
    spec = geometry_spec(walls)
    f = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    steps, bar = fk.FAST_MATH_STEPS, fk.FAST_MATH_RTOL
    want = fk.temporal_reference(f, spec, cfg, steps)
    got = fk.temporal_step(f, torch.empty_like(f), spec, cfg, steps, fast_math=True)
    fast_rel = float(((got - want).abs() / want.abs()).max())
    if not fast_rel <= bar:
        raise AssertionError(f"temporal fast math, one pass of {steps}: max rel {fast_rel!r} > {bar}")
    print(f"temporal kernel, fast math, one pass of {steps} steps vs temporal_reference (IEEE "
          f"1/rho): max rel {fast_rel!r} (bar {bar})")
    del want, got
    print(f"phase 29a (bitwise) took {time.perf_counter() - t_phase:.1f} s")
    t_part = time.perf_counter()

    # 29b. times by depth, in turns
    best, depths_of = {}, {}
    for dtype in (np.float32, bf16):
        cfg = LatticeConfig(nx=800, ny=4000, dtype=dtype)
        st = dtypes[dtype]
        depths = tuple(sorted({*TEMPORAL_DEPTHS, fk.temporal_info(st)["max_steps"]}))
        depths_of[st] = depths
        f = state_tensor(perturbed_state(cfg, rng), dtype, dev)
        rates = rates_printer(cfg, bytes_per_site(dtype))
        for kind in ("spec", "plane"):
            best[(st, kind)] = temporal_times(cfg, walls, kind, f, depths, TEMPORAL_TIMED_STEPS,
                                              rates, f"800x4000 {st}")
        del f
    chosen = {st: min((d for d in depths_of[st] if d > 1), key=lambda d: best[(st, "spec")][d][0])
              for st in dtypes.values()}
    print(f"temporal depth chosen for the main path (fastest pace of the spec variant, T >= 2): "
          f"{ {str(k): v for k, v in chosen.items()} }")
    big = LatticeConfig(nx=4000, ny=16000, dtype=bf16)
    f = state_tensor(initial_state(big), bf16, dev)
    best["4000x16000 bf16"] = temporal_times(
        big, geometry.reference_barrier(4000, 16000), "spec", f, depths_of[torch.bfloat16], 48,
        rates_printer(big, bytes_per_site(bf16)), "4000x16000 torch.bfloat16")
    del f
    torch.cuda.empty_cache()
    small = LatticeConfig(nx=400, ny=2000, dtype=np.float32)
    f = state_tensor(perturbed_state(small, rng), np.float32, dev)
    best["400x2000 f32"] = temporal_times(
        small, geometry.reference_barrier(400, 2000), "spec", f, depths_of[torch.float32],
        TEMPORAL_TIMED_STEPS, rates_printer(small, bytes_per_site(np.float32)),
        "400x2000 torch.float32")
    del f

    print(f"phase 29b (times) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # 29c. the main path at the chosen depths
    n_main = WARMUP + MAIN_STEPS
    entry_launches, variants, main_us = 0, {}, {}
    for dtype, want in ((np.float32, f32_main), (bf16, bf16_main)):
        cfg = LatticeConfig(nx=800, ny=4000, dtype=dtype)
        st = dtypes[dtype]
        depth = chosen[st]
        label = "bf16" if dtype == bf16 else "f32"
        reset_counts()
        sim = Simulation(cfg, walls, backend="cuda", temporal=depth)
        sim.run(n_main)
        launches = n_main // depth + (1 if n_main % depth else 0)
        got_counts = expect_counts(f"{label} temporal main path", {f"temporal-{label}-spec": launches})
        if fk.TEMPORAL_STEPS != n_main:
            raise AssertionError(f"{label} temporal main path: {fk.TEMPORAL_STEPS} steps counted")
        entry_launches += launches
        variants.update(got_counts)
        main_us[label] = sim.elapsed / n_main * 1e6
        state = sim.state()
        if not np.array_equal(state, want):
            raise AssertionError(f"{label} temporal main path at T={depth} != the T=1 main path "
                                 f"after {n_main} steps, max |diff| "
                                 f"{float(np.abs(state - want).max())!r}")
        print(f"temporal main path: Simulation(reference_barrier(800, 4000), backend=cuda, "
              f"temporal={depth}), {label}, {n_main} steps in {launches} counted launches of the "
              f"temporal form ({got_counts}), no one-step launch, {sim.mlups!r} MLUPS "
              f"({sim.elapsed!r} s): bitwise equal to phase "
              f"{13 if dtype == bf16 else 4}'s state at T=1")
        one = Simulation(cfg, walls, backend="cuda", f0=want)
        for every in PROBED_EVERY:
            a = one.run_probed(PROBED_STEPS, PROBES, every=every)
            b = sim.run_probed(PROBED_STEPS, PROBES, every=every)
            if not (np.array_equal(a, b) and np.array_equal(one.state(), sim.state())):
                raise AssertionError(f"{label} temporal run_probed(every={every}) != T=1's")
        print(f"temporal run_probed, {label}, T={depth}: {PROBED_STEPS} steps at every = "
              f"{PROBED_EVERY}, series and state bitwise equal to temporal=None's")
        first, second = TEMPORAL_SPLIT
        if first % depth == 0:
            raise AssertionError(f"the split run's {first} steps are a multiple of T={depth}")
        split = Simulation(cfg, walls, backend="cuda", temporal=depth, f0=want)
        whole = Simulation(cfg, walls, backend="cuda", temporal=depth, f0=want)
        if not np.array_equal(split.run(first).run(second).state(),
                              whole.run(first + second).state()):
            raise AssertionError(f"{label} temporal T={depth}: run({first}) + run({second}) != "
                                 f"run({first + second})")
        print(f"temporal {label}, T={depth}: run({first}) + run({second}) == "
              f"run({first + second}), bitwise")
        del sim, one, split, whole

    print(f"phase 29c (main paths) took {time.perf_counter() - t_part:.1f} s")

    # the entry: one pass of the chosen f32 depth at 800x4000, spec variant
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    depth = chosen[torch.float32]
    a = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    b = torch.empty_like(a)
    ms = queued_ms(lambda: fk.temporal_step(a, b, spec, cfg, depth), 100)
    plain_ms = event_ms(lambda: fk.temporal_reference(a, spec, cfg, depth), 2)
    state_bytes = a.numel() * a.element_size()
    smem_bytes = depth * cfg.sites * 18 * a.element_size()  # 9 values read, 9 written a level
    smem_ms = anatomy.onchip_bound_s(smem_bytes) * 1e3
    print(f"temporal kernel, one pass of {depth} steps at 800x4000 f32 spec: {ms * 1e3!r} us "
          f"queued ({ms * 1e3 / depth!r} us/step); temporal_reference {plain_ms!r} ms; the "
          f"levels' shared-memory bound (computed, {anatomy.SMEM_BYTES_PER_CLOCK} B a clock per "
          f"SM at {anatomy.SM_CLOCK_HZ:.4g} Hz) {smem_ms!r} ms")
    entry = {
        "name": f"lbm_temporal_steps<T, GEOM> (a pass of L steps with walls; main path f32 "
                f"T={chosen[torch.float32]}, bf16 T={chosen[torch.bfloat16]}; ms: one pass of "
                f"{depth} steps, f32 spec, 800x4000)",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_temporal_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1757 (temporal=T, walls)",
        "launches": entry_launches,
        "variant_launches": variants,
        "max_abs_err": err,
        "max_rel_err_fast_math": fast_rel,
        "ms": ms,
        "plain_ms": plain_ms,
        # the pass: the state read once and written once; every level's operations
        **bound(2 * state_bytes, depth * F32_OPS_PER_SITE * cfg.sites),
        "temporal": {str(k): v for k, v in chosen.items()},
        "main_path_us_per_step": main_us,
        "us_per_step_by_T": {f"{k[0]}-{k[1]}" if isinstance(k, tuple) else k:
                             {str(d): {"pace": t[0] * 1e3, "card": t[1] * 1e3,
                                       "enqueue": t[2] * 1e3} for d, t in v.items()}
                             for k, v in best.items()},
        "tile": info,
    }
    return entry


# the pair-DP temporal form (phase 30): the depths timed beside each tile's
# deepest pass, the steps of a timed run (rounded up to a multiple of each
# depth), and the split run's parts, no multiple of DS_TEMPORAL
DS_TEMPORAL_DEPTHS = (1, 2, 3, 4)
# the CTAs an SM of the ds temporal form's tile (csrc/lbm_tile.cuh's
# kCtasPerSm)
DS_TEMPORAL_CTAS_PER_SM = 2
DS_TEMPORAL_TIMED_STEPS = 240
DS_TEMPORAL_SPLIT = (1009, 491)


def ds_pass_traffic(nx, ny, rows, L, has_walls=True):
    """(bytes a pass of the ds temporal form reads, bytes it writes, site
    updates of its levels) at a tile of `rows` rows: each output tile
    reads its rows and 16-byte vectors of columns, halos included, 72 B a
    site and a class byte (masked), writes its sites, and its level t
    updates its output grown by L - t a side."""
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

    v = fdk.TEMPORAL_COLUMNS
    R, C = fk.flat_output(fk.FlatTile(rows, 72), torch.float32, L)
    pad = -(-L // v) * v
    res = [min(R, nx - r0) for r0 in range(0, nx, R)]
    ces = [min(C, ny - c0) for c0 in range(0, ny, C)]
    cols = sum(-(-(pad + ce + L) // v) * v - (pad - L) // v * v for ce in ces)
    site = 2 * 9 * 4  # 9 hi and 9 lo floats
    read = sum(re + 2 * L for re in res) * cols * (site + (1 if has_walls else 0))
    write = sum(res) * sum(ces) * site
    updates = sum(sum(re + 2 * g for re in res) * sum(ce + 2 * g for ce in ces)
                  for g in range(L))
    return read, write, updates


def ds_temporal_bitwise(name, cfg, f, solid, exact, blocked):
    """One pass of the ds temporal form at every L its tile takes, from the
    pair f, bitwise against the chain of step_reference (L steps) and, at
    L <= blocked, against temporal_reference_blocked at that tile. Returns
    max |diff| (0.0)."""
    from latticeboltzmann_tpu_torch.ops import df64
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

    hw = solid is not None
    i = fdk.temporal_info(exact, hw)
    ref, err = f, 0.0
    for steps in range(1, i["max_steps"] + 1):
        ref = fdk.step_reference(ref.hi, ref.lo, solid, cfg, exact)
        label = f"ds temporal {name} L {steps}"
        dst = df64.DS(torch.full_like(f.hi, float("nan")), torch.full_like(f.lo, float("nan")))
        fdk.temporal_step(f, dst, solid, cfg, steps, has_walls=hw, exact=exact)
        err = max(err, bitwise(f"{label}, hi", dst.hi, ref.hi),
                  bitwise(f"{label}, lo", dst.lo, ref.lo))
        if steps <= blocked:
            b = fdk.temporal_reference_blocked(f.hi, f.lo, solid, cfg, exact, steps,
                                               fk.FlatTile(i["rows"], i["width"]))
            bitwise(f"{label}: temporal_reference_blocked, hi", b.hi, ref.hi)
            bitwise(f"{label}: temporal_reference_blocked, lo", b.lo, ref.lo)
    return err


def ds_temporal_phase(main, counts, clock, copy):
    """Phase 30: the pair-DP path's temporal form
    (csrc/lbm_ds_temporal_step.cu), passes of L pair steps. (a) Its tile
    at both tiers and both variants: rows, registers, spills, occupancy,
    the deepest pass. (b) One pass at every L
    the tile takes, both tiers, masked and wall-free, bitwise against the
    chain of step_reference at 5x8 (smaller than one tile), 37x64, 45x1000
    (a ragged last tile in both axes) and 800x4000, and against
    temporal_reference_blocked at the card's tiles for L 1-2 below 100,000
    sites. (c) Chains from rest at 800x4000 in passes of DS_TEMPORAL (100
    fast, 50 exact steps; barrier, symmetric channel, empty box), bitwise
    against step_reference's. (d) Phase 7's main path
    (main: its WARMUP + MAIN_STEPS steps in passes of DS_TEMPORAL) bitwise
    equal to a temporal=1 session's, every launch of that one counted as a
    one-step launch; run(a) + run(b), a no multiple of DS_TEMPORAL, bitwise
    equal to run(a + b). (e) us/step by CUDA events in turns with the
    one-step kernel: T in DS_TEMPORAL_DEPTHS and the tile's deepest, both
    tiers at 800x4000, the fast tier at 400x4000; each time's bounds on
    its own line (bytes per pass at the published rate and at the copy
    kernel's, the issue floor times the levels' recompute). counts, clock:
    ds_phases' SASS counts of the one-step kernel (the same collision) and
    the SM clock; copy: copy_rate's result for one float32 state. Returns
    the kernels line's entry."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.models.engine import initial_state
    from latticeboltzmann_tpu_torch.ops import df64, ds_engine
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
    from latticeboltzmann_tpu_torch.utils import sass

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 30)

    # 30a. the tiles
    info = {}
    for exact in (False, True):
        for hw in (True, False):
            i = info[(exact, hw)] = fdk.temporal_info(exact, hw)
            print(f"ds temporal kernel lbm_ds_temporal_steps<{'masked' if hw else 'wall-free'}, "
                  f"{'exact' if exact else 'fast'}>: tile {i['rows']}x{i['width']} sites, "
                  f"{i['ctas_per_sm']} CTAs/SM, {i['registers']} registers, {i['local_bytes']} B "
                  f"local memory (stack and spills), {i['shared_bytes_per_cta']} shared B/CTA; "
                  f"deepest pass {i['max_steps']} steps")
            if i["ctas_per_sm"] != DS_TEMPORAL_CTAS_PER_SM or i["local_bytes"]:
                raise AssertionError(f"ds temporal tile {exact, hw}: {i}")

    # 30b. bitwise at every depth
    err = 0.0
    for name, nx, ny in (("5x8, smaller than one tile", 5, 8), ("37x64", 37, 64),
                         ("45x1000, a ragged last tile in both axes", 45, 1000),
                         ("800x4000 reference_barrier", 800, 4000)):
        big = nx * ny >= 100_000
        cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64, **({} if big else {"accel": 0.005}))
        if big:
            walls = geometry.reference_barrier(nx, ny)
        else:
            walls = geometry.channel(nx, ny)
            walls[nx // 3: nx // 3 + 2, 0:3] = True
        f0 = initial_state(cfg) * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, (9, nx, ny)))
        f0[6, nx // 2, 0] = 1e-6  # the forcing guard fails at one column-0 site
        f = df64.from_f64(f0, dev)
        solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
        for hw in (True, False):
            for exact in (False, True):
                err = max(err, ds_temporal_bitwise(name, cfg, f, solid if hw else None, exact,
                                                   0 if big else 2))
                print(f"ds temporal kernel vs step_reference, {name} ({'exact' if exact else 'fast'}"
                      f" tier, {'masked' if hw else 'wall-free'}), one pass at every L up to "
                      f"{info[(exact, hw)]['max_steps']}: bitwise"
                      + ("" if big else "; vs temporal_reference_blocked at L 1-2: bitwise"))
        del f, solid
    print(f"phase 30b (bitwise) done at {time.perf_counter() - t_phase:.1f} s")

    # 30c. chains from rest through the session's passes
    big = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    for name, w in (("800x4000 reference_barrier", geometry.reference_barrier(big.nx, big.ny)),
                    ("800x4000 symmetric channel", geometry.channel(big.nx, big.ny)),
                    ("800x4000 empty box", geometry.empty(big.nx, big.ny))):
        for exact in (False, True):
            long_ds_check(name, big, w, exact, temporal=fdk.DS_TEMPORAL)
    print(f"phase 30c (chains) done at {time.perf_counter() - t_phase:.1f} s")

    # 30d. the main path against one step a launch; a split run
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    n_main = WARMUP + MAIN_STEPS
    one = fdk.Session(cfg, walls, device=dev, temporal=1)
    one.load(df64.from_f64(initial_state(cfg), dev))
    reset_counts()
    one.advance(n_main)
    expect_counts("ds main path at temporal=1", {"ds": n_main})
    got, want = main["state"], one.state()
    bitwise("ds main path (temporal form) vs temporal=1, hi", got.hi, want.hi)
    bitwise("ds main path (temporal form) vs temporal=1, lo", got.lo, want.lo)
    print(f"ds main path: {n_main} steps in {main['launches']} counted passes of "
          f"{fdk.DS_TEMPORAL} (phase 7) bitwise equal to a temporal=1 session's {n_main} "
          f"counted one-step launches")
    del one, want
    first, second = DS_TEMPORAL_SPLIT
    f0 = ds_engine.state_f64(got)
    split = Simulation(cfg, walls, backend="cuda-ds64", f0=f0)
    whole = Simulation(cfg, walls, backend="cuda-ds64", f0=f0)
    if not np.array_equal(split.run(first).run(second).state(), whole.run(first + second).state()):
        raise AssertionError(f"cuda-ds64: run({first}) + run({second}) != run({first + second})")
    print(f"cuda-ds64: run({first}) + run({second}) == run({first + second}), bitwise (passes "
          f"{ds_passes(first)} + {ds_passes(second)} against {ds_passes(first + second)})")
    del split, whole, got, main["state"]
    torch.cuda.empty_cache()

    # 30e. times by depth, in turns with the one-step kernel, and bounds
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * FP32_LANES_PER_SM
    copy_rate_bps = 2 * 9 * cfg.sites * 4 / (copy["ms"] * 1e-3)  # one f32 state read and written
    by_t, best_all = {}, {}
    for label, nx, tiers in (("800x4000", 800, (False, True)), ("400x4000", 400, (False,))):
        cfg = LatticeConfig(nx=nx, ny=4000, dtype=np.float64)
        walls = geometry.reference_barrier(nx, 4000)
        f0 = initial_state(cfg) * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, (9, nx, 4000)))
        a = df64.from_f64(f0, dev)
        b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
        solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
        rates = rates_printer(cfg, fdk.BYTES_PER_SITE_DS)
        for exact in tiers:
            tier = "exact" if exact else "fast"
            fns = {"one-step kernel": (lambda exact=exact: fdk.step(
                a, b, solid, cfg, has_walls=True, exact=exact), 1)}
            for L in sorted({*DS_TEMPORAL_DEPTHS, info[(exact, True)]["max_steps"]}):
                fns[f"T={L}"] = (lambda L=L, exact=exact: fdk.temporal_step(
                    a, b, solid, cfg, L, has_walls=True, exact=exact), L)
            best = {}
            for key in list(fns) + list(reversed(fns)):
                fn, L = fns[key]
                n = -(-DS_TEMPORAL_TIMED_STEPS // L)
                us = event_ms(fn, n) * 1e3 / L
                rates(f"ds {label} {tier} tier, {key} (CUDA events, {n} launches of {L} "
                      f"step(s), in turns)", us * 1e-6)
                best[key] = min(best.get(key, us), us)
            fp32 = sum(counts[("ds", True, exact)][k] for k in sass.FP32)
            for key, us in best.items():
                fn, L = fns[key]
                if key == "one-step kernel":
                    continue
                read, write, updates = ds_pass_traffic(nx, 4000, info[(exact, True)]["rows"], L)
                pair_state = 2 * 9 * 4 * cfg.sites
                floor_us = fp32 * updates / (lanes * clock * 1e6) * 1e6 / L
                print(f"ds temporal bound, {label} {tier} tier, {key}: a pass reads {read} B "
                      f"({read / pair_state!r} of the pair state) and writes {write} B: "
                      f"{(read + write) / PEAK_BYTES_PER_S * 1e6 / L!r} us/step at "
                      f"{PEAK_BYTES_PER_S:.3g} B/s, {(read + write) / copy_rate_bps * 1e6 / L!r} at "
                      f"the copy kernel's {copy_rate_bps:.4g} B/s; its levels update "
                      f"{updates / (L * cfg.sites)!r} times the sites: issue floor {floor_us!r} "
                      f"us/step ({fp32} FP32 instructions a site at {clock!r} MHz on {lanes} "
                      f"lanes); measured {us!r} us/step (one-step kernel {best['one-step kernel']!r})")
            by_t[f"{label} {tier}"] = best
            best_all[(label, exact)] = best
        del a, b, solid

    # the entry: one pass of DS_TEMPORAL at 800x4000, the fast tier, masked;
    # its plain version; the bound of the pass
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    walls = geometry.reference_barrier(800, 4000)
    a = df64.from_f64(initial_state(cfg) * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, (9, 800, 4000))),
                      dev)
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    T = fdk.DS_TEMPORAL
    key = f"T={T}"
    plain = {exact: event_ms(lambda exact=exact: fdk.temporal_reference(
        a.hi, a.lo, solid, cfg, exact, T), 1) for exact in (False, True)}
    n_bytes = 4 * a.hi.numel() * 4 + solid.numel()
    bd = counted_bound(n_bytes, counts[("ds", True, False)], cfg.sites * T, clock)
    print(f"ds temporal kernel, one pass of {T} steps at 800x4000, fast tier, masked: "
          f"{best_all[('800x4000', False)][key] * T!r} us (exact tier "
          f"{best_all[('800x4000', True)][key] * T!r}); temporal_reference {plain[False]!r} ms "
          f"(exact {plain[True]!r}); bound of the pass {bd['bound_ms'] * 1e3!r} us by "
          f"{bd['bound_by']} (each input read once, each output written once, {n_bytes} B; "
          f"{bd['ops_per_site']} ops a site-step); main path {main['us_per_step']!r} us/step")
    entry = {
        "name": f"lbm_ds_temporal_steps<HAS_WALLS, EXACT> (a pass of L pair steps; main path "
                f"T={T}; ms: one pass of {T} steps, fast tier, masked, 800x4000)",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_ds_temporal_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_ds_kernel.py:272 (temporal=DS_TEMPORAL)",
        "launches": main["launches"],
        "max_abs_err": err,
        "ms": best_all[("800x4000", False)][key] * T * 1e-3,
        "plain_ms": plain[False],
        "exact_tier_ms": best_all[("800x4000", True)][key] * T * 1e-3,
        "exact_tier_plain_ms": plain[True],
        **bd,
        "main_path_us_per_step": main["us_per_step"],
        "us_per_step_by_T": by_t,
        "tile": {f"{'exact' if k[0] else 'fast'}-{'masked' if k[1] else 'wall-free'}": v
                 for k, v in info.items()},
    }
    return entry


# the pair-DP shard pass (phase 31): the rings of virtual shards held at
# every depth at 800x4000, the halo rows of the held passes, the steps of
# a timed path run, and the calls of a queued timing
DS_EXT_RINGS = (1, 2, 4)
DS_EXT_DEPTH = 4
DS_EXT_TIMED_STEPS = 1000
DS_EXT_QUEUED_CALLS = 50


def ds_ring_shard(a, solid, n, k, depth):
    """Shard k of a ring of n over the card's pair a (rows by modulo): its
    pair, its (top, bot) halo pairs of `depth` rows from the ring
    neighbours, its ShardPlane with (depth, NY) class rows (None without
    solid); whole allocations, so 16-byte aligned."""
    from latticeboltzmann_tpu_torch.ops import df64
    from latticeboltzmann_tpu_torch.ops.fused_kernel import ShardPlane

    nx = a.hi.shape[1]
    L = nx // n

    def rows(x, p, q):
        idx = torch.arange(p, q, device=x.device) % nx
        return x.index_select(x.dim() - 2, idx).contiguous()

    r0 = k * L
    pair = df64.DS(rows(a.hi, r0, r0 + L), rows(a.lo, r0, r0 + L))
    halo = tuple(df64.DS(rows(a.hi, p, q), rows(a.lo, p, q))
                 for p, q in ((r0 - depth, r0), (r0 + L, r0 + L + depth)))
    plane = None if solid is None else ShardPlane(
        rows(solid, r0, r0 + L), rows(solid, r0 - depth, r0), rows(solid, r0 + L, r0 + L + depth))
    return pair, halo, plane


def ds_ext_ranges(Ls, L):
    """(row0, rows) of the launches the two schedules make on a shard of
    Ls rows in a pass of L steps: the whole shard (overlap=False); the
    interior [L, Ls - L) and the two L-row bands (overlap=True)."""
    out = [(0, Ls)]
    if Ls >= 2 * L + 1:
        out += [(L, Ls - 2 * L), (0, L), (Ls - L, L)]
    return out


def ds_ext_bitwise(name, cfg, a, solid, exact, rings, blocked):
    """The ext-halo temporal form on each shard of rings of n shards over
    the pair a: one pass at every L from 1 to DS_EXT_DEPTH with halos of
    DS_EXT_DEPTH rows and, on a ring of one, the deepest pass the tile
    takes at halos of that depth, each row range of the two schedules,
    bitwise against the chain of step_reference on the halo-extended
    block (temporal_reference_ext's) and, at L <= blocked, against
    temporal_reference_ext_blocked at the card's tile over the whole
    shard and the bands; rows outside a range must stay untouched. Returns
    (max |diff|, launches)."""
    from latticeboltzmann_tpu_torch.ops import df64
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

    hw = solid is not None
    info = fdk.temporal_info(exact, hw, ext=True)
    tile = fk.FlatTile(info["rows"], info["width"])
    err, launches = 0.0, 0
    for n in rings:
        for k in range(n):
            depths = [DS_EXT_DEPTH] + ([info["max_steps"]] if n == 1 else [])
            for Td in depths:
                pair, halo, plane = ds_ring_shard(a, solid, n, k, Td)
                Ls = pair.hi.shape[1]
                top, bot = halo
                cur = df64.DS(torch.cat([top.hi, pair.hi, bot.hi], 1),
                              torch.cat([top.lo, pair.lo, bot.lo], 1))
                walls = None if plane is None else torch.cat([plane.top, plane.plane, plane.bot])
                for L in range(1, Td + 1):
                    cur = fdk.step_reference(cur.hi, cur.lo, walls, cfg, exact)
                    if Td != DS_EXT_DEPTH and L != Td:
                        continue
                    want = df64.DS(cur.hi[:, Td:Td + Ls], cur.lo[:, Td:Td + Ls])
                    label = f"ds ext temporal {name}, {n} shard(s), shard {k}, L {L}, Td {Td}"
                    for row0, rows in ds_ext_ranges(Ls, L):
                        dst = df64.DS(torch.full_like(pair.hi, float("nan")),
                                      torch.full_like(pair.lo, float("nan")))
                        fdk.ext_temporal_launcher(pair, dst, halo, plane, cfg, L, has_walls=hw,
                                                  exact=exact, row0=row0, rows=rows)()
                        launches += 1
                        got_hi, got_lo = dst.hi[:, row0:row0 + rows], dst.lo[:, row0:row0 + rows]
                        err = max(err,
                                  bitwise(f"{label}, rows [{row0}, {row0 + rows}), hi", got_hi,
                                          want.hi[:, row0:row0 + rows]),
                                  bitwise(f"{label}, rows [{row0}, {row0 + rows}), lo", got_lo,
                                          want.lo[:, row0:row0 + rows]))
                        outside = torch.ones(Ls, dtype=torch.bool, device=dst.hi.device)
                        outside[row0:row0 + rows] = False
                        if not torch.isnan(dst.hi[:, outside]).all():
                            raise AssertionError(f"{label}: rows outside [{row0}, {row0 + rows}) "
                                                 "written")
                        if L <= blocked and (rows == Ls or row0 == 0):
                            b = fdk.temporal_reference_ext_blocked(
                                pair.hi, pair.lo, halo, plane, cfg, exact, L, tile, row0, rows)
                            bitwise(f"{label}: temporal_reference_ext_blocked, hi", b.hi,
                                    want.hi[:, row0:row0 + rows])
                            bitwise(f"{label}: temporal_reference_ext_blocked, lo", b.lo,
                                    want.lo[:, row0:row0 + rows])
    return err, launches


def ds_ext_traffic(ny, rows, L, ranges):
    """ds_pass_traffic summed over a shard's launches of a pass: each
    range (row0, rows) lays its own tiles."""
    out = [ds_pass_traffic(r, ny, rows, L) for _, r in ranges]
    return tuple(sum(x[i] for x in out) for i in range(3))


def ds_sharded_temporal_phase(counts, clock, copy):
    """Phase 31: the pair-DP shard pass (csrc/lbm_ds_temporal_step.cu's
    ext-halo form, fused_ds_kernel.ext_temporal_launcher): a pass of L
    pair steps on a shard, the rows beyond it from Td-row pair halos. (a)
    Its tile at both tiers and variants: registers, spills, CTAs/SM, the
    deepest pass. (b) One pass at every L 1-4 with 4-row halos (and the
    deepest at Td = that depth on rings of one shard), both tiers, masked
    and wall-free, every row range of both schedules, bitwise against the
    chain of step_reference on the halo-extended block: on rings of 1, 2
    and 4 virtual shards at 800x4000, 2 shards of 5x8 and one of 37x64 (a
    ragged last tile), and against temporal_reference_ext_blocked at the
    card's tile at L 1-2 on the small lattices. (c) The main path:
    sharded-cuda-ds64 over 4 virtual shards of 800x4000 for
    DS_SHARDED_STEPS steps, every pass counted (DS_SHARDED_STEPS / 4 passes
    of 4, one launch per shard and pass; no one-step launch), bitwise equal
    to cuda-ds64 and to a temporal=1 sharded session's counted one-step
    launches; over 4 cards where there are 4. (d) Times in turns by the
    host clock with enqueue: the path at temporal=1 (the one-step form),
    at passes of 4 with overlap=True and overlap=False, beside cuda-ds64, on
    4 virtual shards and on one shard; the halo exchange alone per pass;
    one pass's launches at L 1-4 queued behind a spin, by CUDA events,
    beside the local temporal form's pass; each with its bounds (bytes per
    pass at the published rate and the copy kernel's, the issue floor
    times the levels' recompute). counts, clock: ds_phases' SASS counts
    and SM clock; copy: copy_rate's result for one float32 state. Returns
    the kernels line's entry."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.models import engine
    from latticeboltzmann_tpu_torch.models.engine import initial_state
    from latticeboltzmann_tpu_torch.ops import df64
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
    from latticeboltzmann_tpu_torch.parallel import sharded
    from latticeboltzmann_tpu_torch.utils import sass

    torch.cuda.empty_cache()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 31)
    T = fdk.DS_TEMPORAL

    # 31a. the tiles
    info = {}
    for exact in (False, True):
        for hw in (True, False):
            i = info[(exact, hw)] = fdk.temporal_info(exact, hw, ext=True)
            print(f"ds ext-halo temporal kernel lbm_ds_temporal_steps_ext<"
                  f"{'masked' if hw else 'wall-free'}, {'exact' if exact else 'fast'}>: tile "
                  f"{i['rows']}x{i['width']} sites, {i['ctas_per_sm']} CTAs/SM, {i['registers']} "
                  f"registers, {i['local_bytes']} B local memory (stack and spills), "
                  f"{i['shared_bytes_per_cta']} shared B/CTA; deepest pass {i['max_steps']} steps")
            if i["ctas_per_sm"] != DS_TEMPORAL_CTAS_PER_SM or i["local_bytes"]:
                raise AssertionError(f"ds ext temporal tile {exact, hw}: {i}")
    t_part = time.perf_counter()

    # 31b. bitwise at every depth and row range
    err, held = 0.0, 0
    reset_counts()
    for name, nx, ny, rings in (("800x4000 reference_barrier", 800, 4000, DS_EXT_RINGS),
                                ("10x8 (5-row shards, one tile wider than the lattice)", 10, 8,
                                 (2,)),
                                ("37x64 (a ragged last tile)", 37, 64, (1,))):
        big = nx * ny >= 100_000
        cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64, **({} if big else {"accel": 0.005}))
        if big:
            walls = geometry.reference_barrier(nx, ny)
        else:
            walls = geometry.channel(nx, ny)
            walls[nx // 2 - 1: nx // 2 + 1, 0:3] = True
        f0 = initial_state(cfg) * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, (9, nx, ny)))
        f0[6, nx // 2, 0] = 1e-6  # the forcing guard fails at one column-0 site
        a = df64.from_f64(f0, dev)
        solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
        for hw in (True, False):
            for exact in (False, True):
                e, n = ds_ext_bitwise(name, cfg, a, solid if hw else None, exact, rings,
                                      0 if big else 2)
                err, held = max(err, e), held + n
                print(f"ds ext-halo temporal kernel vs the chain of step_reference on the "
                      f"halo-extended block, {name} ({'exact' if exact else 'fast'} tier, "
                      f"{'masked' if hw else 'wall-free'}), rings of {list(rings)} shard(s), L 1-"
                      f"{DS_EXT_DEPTH} at Td {DS_EXT_DEPTH}"
                      + (f" and L {info[(exact, hw)]['max_steps']} at Td "
                         f"{info[(exact, hw)]['max_steps']}" if 1 in rings else "")
                      + f", every row range of both schedules ({n} launches): bitwise"
                      + ("" if big else "; vs temporal_reference_ext_blocked at L 1-2: bitwise"))
        del a, solid
    torch.cuda.synchronize()
    expect_counts("phase 31b", {"ds-ext-temporal": held})
    print(f"phase 31b (bitwise) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # 31c. the main path, counted, against cuda-ds64 and against temporal=1
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    walls = geometry.reference_barrier(800, 4000)
    want = Simulation(cfg, walls, backend="cuda-ds64").run(DS_SHARDED_STEPS).state()
    meshes = {f"{VIRTUAL_SHARDS} virtual shards": sharded.make_mesh(
        devices=[dev] * VIRTUAL_SHARDS)}
    if torch.cuda.device_count() >= VIRTUAL_SHARDS:
        meshes[f"{VIRTUAL_SHARDS} cards"] = sharded.make_mesh(VIRTUAL_SHARDS)
    else:
        print(f"{torch.cuda.device_count()} card(s) visible: the sharded-cuda-ds64 passes over a "
              f"mesh of {VIRTUAL_SHARDS} cards were not run")
    main_launches = None
    for label, mesh in meshes.items():
        engine.register_backend("sharded-cuda-ds64", sharded.make_cuda_ds_backend(mesh))
        reset_counts()
        sharded.HALO_COPIES = 0
        sim = Simulation(cfg, walls, backend="sharded-cuda-ds64")
        sim.run(DS_SHARDED_STEPS)
        passes = DS_SHARDED_STEPS // T
        got_counts = expect_counts(f"sharded-cuda-ds64 over {label}",
                                   {"ds-ext-temporal": passes * mesh.size})
        if fdk.EXT_TEMPORAL_STEPS != DS_SHARDED_STEPS * mesh.size:
            raise AssertionError(f"sharded-cuda-ds64 over {label}: {fdk.EXT_TEMPORAL_STEPS} "
                                 f"steps in its launches, expected {DS_SHARDED_STEPS * mesh.size}")
        # per pass both components' two halos a shard; once a session the
        # static halo class rows
        copies = sharded.HALO_COPIES
        if copies != passes * 2 * 2 * mesh.size + 2 * mesh.size:
            raise AssertionError(f"sharded-cuda-ds64 over {label}: {copies} halo copies, expected "
                                 f"{passes * 4 * mesh.size + 2 * mesh.size} (one exchange per "
                                 "pass, the class rows once)")
        got = sim.state()
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded-cuda-ds64 over {label} != cuda-ds64 after "
                                 f"{DS_SHARDED_STEPS} steps, max |diff| "
                                 f"{float(np.abs(got - want).max())!r}")
        if main_launches is None:
            main_launches = got_counts["ds-ext-temporal"]
        print(f"sharded-cuda-ds64 over {label}: {DS_SHARDED_STEPS} steps in {passes} passes of {T}, "
              f"{got_counts['ds-ext-temporal']} counted launches of the ext-halo temporal form (one "
              f"per shard and pass; no one-step launch), {copies} halo copies ({2 * 2 * mesh.size} "
              f"of (9, {T}, 4000) a pass, {2 * mesh.size} class blocks once), bitwise equal to "
              f"cuda-ds64, Re {sim.reynolds()!r}")
        del sim
    one = sharded.ShardedDSSession(cfg, walls, mesh=meshes[f"{VIRTUAL_SHARDS} virtual shards"],
                                   temporal=1)
    one.load(df64.from_f64(initial_state(cfg), dev))
    reset_counts()
    one.advance(DS_SHARDED_STEPS)
    expect_counts("sharded-cuda-ds64 at temporal=1", {"ds-ext": DS_SHARDED_STEPS * VIRTUAL_SHARDS})
    if not np.array_equal(df64.to_f64(one.unload()), want):
        raise AssertionError("the temporal=1 sharded session != cuda-ds64")
    print(f"ShardedDSSession(temporal=1) over {VIRTUAL_SHARDS} virtual shards: "
          f"{DS_SHARDED_STEPS * VIRTUAL_SHARDS} counted one-step ext-halo launches, bitwise equal "
          "to cuda-ds64 and so to the passes of 4")
    del one, want
    engine.register_backend("sharded-cuda-ds64", sharded.make_cuda_ds_backend(
        meshes[f"{VIRTUAL_SHARDS} virtual shards"]))
    print(f"phase 31c (main path) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # 31d. times: the paths in turns by the host clock, with enqueue
    rates = rates_printer(cfg, fdk.BYTES_PER_SITE_DS)
    path_us = {}
    for mesh_label, n in ((f"{VIRTUAL_SHARDS} virtual shards", VIRTUAL_SHARDS), ("1 shard", 1)):
        mesh = sharded.make_mesh(devices=[dev] * n)
        group = {"cuda-ds64": Simulation(cfg, walls, backend="cuda-ds64")}
        for label, kw in (("temporal=1 (one-step form, overlap)", dict(temporal=1, overlap=True)),
                          (f"passes of {T}, overlap=True", dict(overlap=True)),
                          (f"passes of {T}, overlap=False", dict(overlap=False))):
            engine.register_backend("sharded-cuda-ds64", sharded.make_cuda_ds_backend(mesh, **kw))
            group[f"sharded-cuda-ds64 {mesh_label}, {label}"] = Simulation(
                cfg, walls, backend="sharded-cuda-ds64")
        for sim in group.values():
            sim.run(2 * T)
        torch.cuda.synchronize()
        best = {}
        order = list(group) + list(reversed(group))
        for key in order + order:
            sim = group[key]
            t0 = time.perf_counter()
            sim.run(DS_EXT_TIMED_STEPS, block=False)
            enqueue = (time.perf_counter() - t0) / DS_EXT_TIMED_STEPS
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / DS_EXT_TIMED_STEPS
            rates(f"{key} (host clock, {DS_EXT_TIMED_STEPS} steps, in turns; enqueue "
                  f"{enqueue * 1e6!r} us/step)", sec)
            prev = best.get(key, (float("inf"), float("inf")))
            best[key] = (min(prev[0], sec * 1e6), min(prev[1], enqueue * 1e6))
        path_us[mesh_label] = best
        for key in (k for k in group if f"passes of {T}" in k):
            sess = group[key]._session
            copies = sess._plans[sess._parity][0]
            ms = event_ms(lambda sess=sess, copies=copies: (sess.exchange.start(copies),
                                                            sess.exchange.finish()), 500)
            print(f"halo exchange alone, {key}: {ms * 1e3!r} us a pass ({len(copies)} copies of "
                  f"(9, {T}, 4000) float32), {ms * 1e3 / T!r} us/step (CUDA events, 500 "
                  "exchanges)")
            break
        del group
    engine.register_backend("sharded-cuda-ds64", sharded.make_cuda_ds_backend(
        meshes[f"{VIRTUAL_SHARDS} virtual shards"]))
    torch.cuda.empty_cache()

    # one pass's launches queued behind a spin, by depth, beside the local
    # temporal form's pass; each time's bounds
    a = df64.from_f64(initial_state(cfg) * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, (9, 800, 4000))),
                      dev)
    b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * FP32_LANES_PER_SM
    copy_rate_bps = 2 * 9 * cfg.sites * 4 / (copy["ms"] * 1e-3)
    fp32 = sum(counts[("ds", True, False)][k] for k in sass.FP32)
    rows_tile = info[(False, True)]["rows"]
    rings = {n: [ds_ring_shard(a, solid, n, k, DS_EXT_DEPTH) for k in range(n)]
             for n in (VIRTUAL_SHARDS, 1)}
    outs = {n: [df64.DS(torch.empty_like(p.hi), torch.empty_like(p.lo)) for p, _, _ in ring]
            for n, ring in rings.items()}
    pass_us, bounds = {}, {}
    for L in range(1, DS_EXT_DEPTH + 1):
        fns = {"local temporal form (1 launch)": lambda L=L: fdk.temporal_step(
            a, b, solid, cfg, L, has_walls=True)}
        for n, ring in rings.items():
            Ls = 800 // n
            for overlap in (False, True):
                ranges = ds_ext_ranges(Ls, L)
                ranges = ranges[1:] if overlap and len(ranges) > 1 else ranges[:1]
                calls = [fdk.ext_temporal_launcher(p, outs[n][k], None if row0 >= L and
                                                   row0 + r + L <= Ls else h, pl, cfg, L,
                                                   has_walls=True, row0=row0, rows=r)
                         for k, (p, h, pl) in enumerate(ring) for row0, r in ranges]
                key = (f"{n} shard(s), {'interior + bands' if overlap else 'one launch per shard'}"
                       f" ({len(calls)} launches)")
                fns[key] = lambda calls=calls: [c() for c in calls]
                read, write, updates = ds_ext_traffic(4000, rows_tile, L, ranges)
                bounds[L, key] = (n * read, n * write, n * updates)
        t = in_turns(lambda label, sec, L=L: rates(label, sec / L), f"ds ext-halo temporal, "
                     f"one pass of {L}", fns, DS_EXT_QUEUED_CALLS, timer=queued_ms)
        for key, ms in t.items():
            pass_us[L, key] = ms * 1e3
            if (L, key) not in bounds:
                continue
            read, write, updates = bounds[L, key]
            pair_state = 2 * 9 * 4 * cfg.sites
            floor_us = fp32 * updates / (lanes * clock * 1e6) * 1e6 / L
            print(f"ds ext-halo temporal bound, one pass of {L}, {key}: reads {read} B "
                  f"({read / pair_state!r} of the pair state) and writes {write} B: "
                  f"{(read + write) / PEAK_BYTES_PER_S * 1e6 / L!r} us/step at "
                  f"{PEAK_BYTES_PER_S:.3g} B/s, {(read + write) / copy_rate_bps * 1e6 / L!r} at the "
                  f"copy kernel's {copy_rate_bps:.4g} B/s; its levels update "
                  f"{updates / (L * cfg.sites)!r} times the sites: issue floor {floor_us!r} us/step "
                  f"({fp32} FP32 instructions a site at {clock!r} MHz on {lanes} lanes); measured "
                  f"{ms * 1e3 / L!r} us/step (local temporal form "
                  f"{t['local temporal form (1 launch)'] * 1e3 / L!r})")

    # the entry: one pass of T on 4 virtual shards, one launch per shard
    # (the path's schedule), fast tier, masked; its plain version; the bound
    ring = rings[VIRTUAL_SHARDS]
    plain_ms = event_ms(lambda: [fdk.temporal_reference_ext(p.hi, p.lo, h, pl, cfg, False, T)
                                 for p, h, pl in ring], 1)
    halo_bytes = sum(t.numel() * 4 for _, h, _ in ring for side in h for t in side)
    halo_bytes += sum(pl.top.numel() + pl.bot.numel() for _, _, pl in ring)
    n_bytes = 4 * a.hi.numel() * 4 + solid.numel() + halo_bytes
    bd = counted_bound(n_bytes, counts[("ds", True, False)], cfg.sites * T, clock)
    fused = next(k for (L, k) in pass_us if L == T and k.startswith(f"{VIRTUAL_SHARDS} shard(s), "
                                                                     "one launch"))
    overlap_key = next(k for (L, k) in pass_us if L == T and k.startswith(
        f"{VIRTUAL_SHARDS} shard(s), interior"))
    one_key = next(k for (L, k) in pass_us if L == T and k.startswith("1 shard(s), one launch"))
    print(f"ds ext-halo temporal kernel, one pass of {T} on {VIRTUAL_SHARDS} virtual shards of "
          f"800x4000, one launch per shard: {pass_us[T, fused]!r} us (interior + bands "
          f"{pass_us[T, overlap_key]!r}; one shard {pass_us[T, one_key]!r}; the local temporal "
          f"form {pass_us[T, 'local temporal form (1 launch)']!r}); temporal_reference_ext over "
          f"{VIRTUAL_SHARDS} shards {plain_ms!r} ms; bound of the pass {bd['bound_ms'] * 1e3!r} us "
          f"by {bd['bound_by']} ({n_bytes} B, each input read once and each output written once)")
    print(f"phase 31d (times) took {time.perf_counter() - t_part:.1f} s")
    return {
        "name": f"lbm_ds_temporal_steps_ext<HAS_WALLS, EXACT> (a shard's pass of L pair steps, "
                f"Td-row pair halos; main path sharded-cuda-ds64 over {VIRTUAL_SHARDS} virtual "
                f"shards in passes of {T}, one launch per shard and pass; ms: one pass's "
                f"{VIRTUAL_SHARDS} launches, fast tier, masked, 800x4000)",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_ds_temporal_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_ds_kernel.py:272 (ext_halo=True, "
                    "temporal=DS_TEMPORAL)",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": pass_us[T, fused] * 1e-3,
        "plain_ms": plain_ms,
        "interior_and_bands_ms": pass_us[T, overlap_key] * 1e-3,
        "one_shard_ms": pass_us[T, one_key] * 1e-3,
        **bd,
        "pass_us_by_L": {f"L={L} {k}": v for (L, k), v in pass_us.items()},
        "path_us_per_step_and_enqueue": path_us,
        "tile": {f"{'exact' if k[0] else 'fast'}-{'masked' if k[1] else 'wall-free'}": v
                 for k, v in info.items()},
    }



if __name__ == "__main__":
    sys.exit(main())
