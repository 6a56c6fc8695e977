"""On-card kernel anatomy: where does the step time go on this GPU?

Twin of the JAX package's scripts/anatomy.py. It measures, on a CUDA
card, the raw ceilings that bound the fused stream-collide kernel at the
headline configuration (800x4000) and the cost of the pieces a step is
made of, with the port's hand-written probe kernels (ops/probes.py,
csrc/lbm_probes.cu) and its flat multi-step kernel
(fused_kernel.make_flat_step, csrc/lbm_flat_step.cu):

  copy    the copy kernel, direct (on a covering and on a persistent grid)
          and staged through shared memory at a few (rows, stages) pairs,
          float32 and bf16, beside Tensor.copy_
          (the library's copy) and an elementwise x.add_(1.0) loop: the
          bandwidth ceiling every step kernel is judged against
  roll    ns per periodic y-shift of a resident (32, NY) block, through
          shared memory (both forms: the narrow one a row per CTA, the
          wide one across a thread-block cluster) and through warp
          shuffles, beside torch.roll
  align   ns per add on row-offset and column-offset windows of a
          resident (40, NY) block; ns per x-shift (rows) of the block held
          in shared memory (both forms) and re-read from global memory,
          beside torch.roll
  flat    the flat kernel's us/step (16 and 64 steps per launch at its
          default temporal depth T, the JAX script's (T, steps) pairs, T
          = 1..5 at 16 steps and T = 4..16 at 64 steps, float32 and bf16,
          and on a lattice whose two parities fit the L2 cache) between
          two anchors of the one-launch-per-step kernel
  prod    the cuda backend's session (one launch per step) on the scaled
          and the reference scene
  bf16    float32 against bf16 storage on the reference scene
  all     every section above

Every time is taken by CUDA events: a slope between two counts, which
cancels the launch and a block's load and store, or, for the
launch-per-step session, launches queued behind a spin so that the card
and not the host sets the pace. Beside each on-chip reading stands its
share of the card's shared-memory bound: the bytes a roll or add moves
through shared memory (or L1) at 128 B per clock on every SM at the
H100's 1.98 GHz boost clock. The first line printed is the
card's name and power limit. Without a CUDA card the script exits
non-zero: no section runs on the CPU.

The JAX script's other sections (ablate, sweep, floor, skew, launchtax,
slim, split, xla) model the TPU compiler's launch cost and VMEM and have
no counterpart here; asking for one exits with a message.

Usage:  python -m latticeboltzmann_tpu_torch.scripts.anatomy
            [--section all] [--steps 400] [--nx 800] [--ny 4000]
"""

from __future__ import annotations

import argparse
import sys

import torch

NX, NY = 800, 4000
NSP = 9
SECTIONS = ("all", "copy", "roll", "align", "flat", "prod", "bf16")
# sections of the JAX script that are not sections here, and why
TPU_LABS = {
    "xla": "the elementwise-loop ceiling is part of --section copy",
    "ablate": "it removes pieces of the TPU kernel's body one at a time",
    "sweep": "it sweeps the TPU kernel's temporal depth and block rows",
    "floor": "it prices the TPU launch partition's wall handling",
    "skew": "it compares the TPU kernel's wavefront and trapezoid schedules",
    "launchtax": "it measures the TPU compiler's cost per launch boundary",
    "slim": "it compares two DMA stagings of the TPU kernel",
    "split": "it compares TPU launch partitions",
}
# (rows, stages) of the staged copy, as the JAX script sweeps (br, slots)
COPY_STAGING = ((1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (4, 3))
# CTAs per SM of the direct copy's persistent-grid variant
COPY_PERSISTENT = (8, 32)
ROLL_ROWS = 32
ALIGN_ROWS = 40
# steps per launch of the flat kernel at its default temporal depth
FLAT_CHUNKS = (16, 64)
# (temporal, steps per launch) pairs of the JAX script's flat section
FLAT_PAIRS = ((3, 48), (3, 96), (4, 64), (2, 32))
# temporal depths of the sweep at FLAT_CHUNKS[0] steps per launch (from 5
# on, 16 steps run as passes of 5, 5, 5, 1) and at FLAT_CHUNKS[1]
FLAT_SWEEP = (1, 2, 3, 4, 5)
FLAT_DEPTHS = (4, 6, 8, 12, 16)
# the on-chip bound: an SM's shared memory (and L1) moves 128 B per clock
# (32 banks of 4 B; the Hopper architecture white paper), at the H100
# SXM's 1.98 GHz boost clock
SMEM_BYTES_PER_CLOCK = 128
SM_CLOCK_HZ = 1.98e9


def onchip_bound_s(n_bytes):
    """The least time for n_bytes of shared-memory (or L1) traffic spread
    over every SM of the card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_bytes / (SMEM_BYTES_PER_CLOCK * SM_CLOCK_HZ * sms)


def report(label, dt, traffic_bytes=None, sites_steps=None):
    line = f"{label:54s} {dt * 1e6:9.2f} us/pass"
    if traffic_bytes:
        line += f"  {traffic_bytes / dt / 1e9:7.1f} GB/s"
    if sites_steps:
        line += f"  {sites_steps / dt / 1e6:9.0f} MLUPS"
    print(line, flush=True)


def report_ns(label, dt, onchip_bytes):
    """One on-chip operation: ns per roll or add over the whole block, the
    on-chip bytes it moves per second, and the card's shared-memory bound
    (onchip_bound_s) over the time."""
    print(f"{label:54s} {dt * 1e9:9.1f} ns/op    {onchip_bytes / dt / 1e9:8.1f} GB/s on chip"
          f"  {onchip_bound_s(onchip_bytes) / dt:6.3f} of the bound", flush=True)


def _state(nx, ny, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((NSP, nx, ny), generator=gen, device="cuda", dtype=torch.float32)
    return x.to(dtype)


def _block(rows, ny, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((rows, ny), generator=gen, device="cuda", dtype=torch.float32)


# ------------------------------------------------------------------ copy


def copy_section(steps, nx, ny):
    from ..ops import probes
    from ..utils.timing import timed_slope

    n1, n2 = max(steps // 2, 2), max(steps, 4)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        a = _state(nx, ny, dtype)
        b = torch.empty_like(a)
        traffic = 2 * a.numel() * a.element_size()

        def times(label, fn):
            dt = timed_slope(lambda n: [fn() for _ in range(n)], n1, n2)
            report(f"{label} {tag} ({nx}x{ny})", dt, traffic_bytes=traffic)

        if dtype == torch.float32:
            x = a.clone()
            times("elementwise x.add_(1.0) loop", lambda: x.add_(1.0))
            del x
        times("Tensor.copy_ (the library's copy)", lambda: b.copy_(a))
        times("copy direct", lambda: probes.copy_state(a, b))
        for ctas in COPY_PERSISTENT:
            times(f"copy direct, persistent grid, {ctas} CTAs/SM",
                  lambda: probes.copy_state(a, b, ctas_per_sm=ctas))
        for rows, stages in COPY_STAGING:
            try:
                times(f"copy staged rows={rows} stages={stages}",
                      lambda: probes.copy_state(a, b, rows=rows, stages=stages))
            except ValueError as e:  # a tile the staged form does not take
                print(f"copy staged rows={rows} stages={stages} {tag}: refused ({e})", flush=True)
        if not torch.equal(a, b):
            raise AssertionError(f"copy section: dst != src ({tag})")


# ------------------------------------------------------------ roll, align


def roll_section(steps, ny):
    from ..ops import probes
    from ..utils.timing import queued_ms, timed_slope

    x = _block(ROLL_ROWS, ny)
    out = torch.empty_like(x)
    n1 = max(steps, 2000)
    onchip = 2 * x.numel() * 4  # 4 B read and 4 B written per element and roll
    print(f"shared-memory bound of a y-roll ({ROLL_ROWS}x{ny}) over the card's SMs: "
          f"{onchip_bound_s(onchip) * 1e9:.1f} ns", flush=True)

    def slope(fn):
        return timed_slope(lambda n: fn(n), n1, 2 * n1)

    for shift in (1, 2, ny - 1, 96, ny):
        for label, kw in (("narrow", {"form": "narrow"}), ("wide", {"form": "wide"}),
                          ("shuffle", {"mechanism": "shuffle"})):
            try:
                probes.roll_y(x, shift, 0, out=out, **kw)
            except ValueError:  # a shift or NY the form or mechanism does not take
                continue
            dt = slope(lambda n: probes.roll_y(x, shift, n, out=out, **kw))
            report_ns(f"roll_y shift={shift:5d} {label:7s} ({ROLL_ROWS}x{ny})", dt, onchip)
        lib = queued_ms(lambda: torch.roll(x, shift, 1), 200) * 1e-3
        report_ns(f"torch.roll shift={shift:5d}, one call per roll", lib, onchip)
    if ny % (4 * probes.ROLL_Y_CLUSTER) == 0:  # the wide form's launch shape
        print(f"roll_y wide: {ROLL_ROWS * probes.ROLL_Y_CLUSTER} CTAs in clusters of "
              f"{probes.ROLL_Y_CLUSTER}, at most {probes.roll_y_clusters(ROLL_ROWS, ny)} clusters "
              "active at once (cudaOccupancyMaxActiveClusters)", flush=True)


def align_section(steps, ny):
    from ..ops import probes
    from ..utils.timing import queued_ms, timed_slope

    x = _block(ALIGN_ROWS, ny)
    n1 = max(steps, 2000)
    for axis in (0, 1):
        for offset in (0, 1, 2):
            out = probes.align(x, offset, 0, axis=axis)
            dt = timed_slope(lambda n: probes.align(x, offset, n, axis=axis, out=out), n1, 2 * n1)
            # one 4-byte operand re-read per element and add
            report_ns(f"add offset={offset} axis={axis} ({ALIGN_ROWS}x{ny})", dt, out.numel() * 4)
    out = torch.empty_like(x)
    onchip = 2 * x.numel() * 4
    print(f"shared-memory bound of an x-roll ({ALIGN_ROWS}x{ny}) over the card's SMs: "
          f"{onchip_bound_s(onchip) * 1e9:.1f} ns", flush=True)
    for shift in (1, ALIGN_ROWS - 1):
        for label, kw in (("narrow", {"form": "narrow"}), ("wide", {"form": "wide"}),
                          ("global", {"mechanism": "global"})):
            try:
                probes.roll_x(x, shift, 0, out=out, **kw)
            except ValueError:  # an NY the wide form does not take
                continue
            dt = timed_slope(lambda n: probes.roll_x(x, shift, n, out=out, **kw), n1, 2 * n1)
            report_ns(f"roll_x shift={shift:2d} {label:6s} ({ALIGN_ROWS}x{ny})", dt, onchip)
        lib = queued_ms(lambda: torch.roll(x, shift, 0), 200) * 1e-3
        report_ns(f"torch.roll axis 0 shift={shift:2d}, one call per roll", lib, onchip)


# ------------------------------------------------------- the step kernels


def production(steps, nx, ny, dtype="float32", scene="reference", tag=""):
    """The cuda backend's session: one launch of the step kernel per step,
    the wall-spec variant on a closed-form scene, the wall-free variant on
    the empty one."""
    from ..core import geometry
    from ..core.spec import LatticeConfig
    from ..models.engine import initial_state
    from ..ops import fused_kernel as fk
    from ..utils.interop import state_tensor
    from ..utils.timing import queued_ms

    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
    walls = {"reference": geometry.reference_barrier, "scaled": geometry.channel_with_barrier,
             "empty": geometry.empty}[scene](nx, ny)
    spec = geometry.infer_spec(walls) if walls.any() else None
    sess = fk.Session(cfg, walls, device="cuda", wall_spec=spec, temporal=1)
    sess.load(state_tensor(initial_state(cfg), cfg.dtype, "cuda"))
    # queued behind a spin: on a small lattice the host's launch rate, not
    # the card, would set a launch-per-step loop's pace
    dt = queued_ms(lambda: sess.advance(10), max(steps // 10, 2)) * 1e-3 / 10
    report(f"production {scene} {dtype} ({nx}x{ny}) {tag}", dt, sites_steps=nx * ny)
    return dt


def flat(steps, nx, ny, chunk, dtype="float32", tag="", temporal=None):
    """The flat kernel: `chunk` wall-free steps per launch, at passes of up
    to `temporal` steps (default: the kernel's for the storage)."""
    from ..core.spec import LatticeConfig
    from ..models.engine import initial_state
    from ..ops import fused_kernel as fk
    from ..utils.interop import state_tensor, storage_dtype
    from ..utils.timing import timed_slope

    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
    st = storage_dtype(cfg.dtype)
    temporal = fk.FLAT_TEMPORAL[st] if temporal is None else temporal
    fk.make_flat_step(cfg, chunk, temporal=temporal)  # the guards
    f = state_tensor(initial_state(cfg), cfg.dtype, "cuda")
    f2 = torch.stack([f, f])
    n1 = max(steps // chunk, 2)
    dt = timed_slope(lambda n: [fk.flat_step(f2, cfg, chunk, temporal=temporal)
                                for _ in range(n)], n1, 3 * n1, steps_per_n=chunk)
    info = fk.flat_info(st)
    tile = fk.flat_tile(st)
    report(f"flat {chunk} steps/launch T={temporal} {dtype} ({nx}x{ny}) {tag}".strip(), dt,
           sites_steps=nx * ny)
    out_r, out_c = fk.flat_output(tile, st, temporal)
    print(f"    tile {tile.rows}x{tile.width} (output {out_r}x{out_c} at T steps), "
          f"{info['ctas_per_sm']} CTAs/SM, "
          f"{info['registers']} registers, {info['shared_bytes_per_cta']} shared B/CTA, "
          f"{info['local_bytes']} B local memory", flush=True)
    return dt


def flat_section(steps, nx, ny):
    production(steps, nx, ny, scene="empty", tag="anchor")
    for dtype in ("float32", "bfloat16"):
        for chunk in FLAT_CHUNKS:
            flat(steps, nx, ny, chunk, dtype)
        for temporal, chunk in FLAT_PAIRS:
            flat(steps, nx, ny, chunk, dtype, temporal=temporal)
        for temporal in FLAT_SWEEP:
            flat(steps, nx, ny, FLAT_CHUNKS[0], dtype, temporal=temporal)
        for temporal in FLAT_DEPTHS:
            flat(steps, nx, ny, FLAT_CHUNKS[1], dtype, temporal=temporal)
    production(steps, nx, ny, dtype="bfloat16", scene="empty")
    # a lattice whose two bf16 parities fit the L2 cache together
    sx, sy = max(nx // 2, 2), max(ny // 2, 2)
    production(steps, sx, sy, dtype="bfloat16", scene="empty", tag="fits L2")
    flat(steps, sx, sy, FLAT_CHUNKS[0], "bfloat16", tag="fits L2")
    production(steps, nx, ny, scene="empty", tag="anchor again")


def prod_section(steps, nx, ny):
    for scene in ("scaled", "reference"):
        production(steps, nx, ny, scene=scene)


def bf16_section(steps, nx, ny):
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        production(steps, nx, ny, dtype=dtype)


# ------------------------------------------------------------------ main


def _section(name: str) -> str:
    if name in TPU_LABS:
        raise argparse.ArgumentTypeError(
            f"section {name!r} is a TPU lab of the JAX script and is not ported: "
            f"{TPU_LABS[name]}; the sections here are {', '.join(SECTIONS)}")
    if name not in SECTIONS:
        raise argparse.ArgumentTypeError(
            f"unknown section {name!r}; choose from {', '.join(SECTIONS)}")
    return name


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m latticeboltzmann_tpu_torch.scripts.anatomy",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--section", type=_section, default="all", metavar="|".join(SECTIONS))
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--ny", type=int, default=NY)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("anatomy: no CUDA card (torch.cuda.is_available() is False); the probes "
              "time this card's kernels and have no CPU mode", file=sys.stderr)
        return 2
    from ..bench import card_info

    print(f"card: {card_info()}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, lattice {args.nx}x{args.ny}, "
          f"--steps {args.steps}", flush=True)
    sections = {
        "copy": lambda: copy_section(args.steps, args.nx, args.ny),
        "roll": lambda: roll_section(args.steps, args.ny),
        "align": lambda: align_section(args.steps, args.ny),
        "flat": lambda: flat_section(args.steps, args.nx, args.ny),
        "prod": lambda: prod_section(args.steps, args.nx, args.ny),
        "bf16": lambda: bf16_section(args.steps, args.nx, args.ny),
    }
    for name, run in sections.items():
        if args.section in ("all", name):
            run()
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
