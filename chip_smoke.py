"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure:
1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles csrc/lbm_step.cu and csrc/lbm_ds_step.cu with nvcc
   (timed) and prints ptxas's registers and spills for every kernel
   instantiation;
3. the float32 stream-collide kernel against its plain PyTorch version
   (fused_kernel.step_reference) on the card, one step at a time from
   identical inputs, at four scenes, plane and wall-free variants; they
   must agree bitwise;
4. the main path: Simulation(backend="cuda") on the 800x4000 reference
   scene (the wall spec variant, as the JAX main path) for 10,000 steps
   after a warmup, every step a counted kernel launch; the state must be
   finite and non-negative and Re finite, and a 20-step run must match
   the "torch" backend on the same card;
5. times at 800x4000 of the kernel's plane and spec variants (in turns),
   its plain version, the plain "torch" engine and a device copy of the
   state (the bandwidth bound);
6. the pair-DP (ds) kernel against its plain version
   (fused_ds_kernel.step_reference) on the card, both tiers (fast and
   exact) and both variants, 10 single steps each at the four scenes of
   phase 3 from a perturbed float64 state split into pairs; bitwise;
7. the ds main path: Simulation(backend="cuda-ds64") on the 800x4000
   reference scene for 10,000 steps after a warmup, every step a counted
   launch; the state must be finite and non-negative and Re finite, and
   a 200-step run from rest must match the float64 "torch" backend on the
   same card within 1e-11 relative;
8. times at 800x4000 of the ds kernel at each tier, its plain versions,
   the eager "torch-ds64" engine, and the ds main path's slope;
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
   every step a counted launch; finite and non-negative, Re finite, and
   within the JAX package's bf16 bar of the float32 main path of phase 4
   after the same steps; a 20-step run within that bar of the bf16
   "torch" backend;
14. times: the bf16 spec and plane variants at 800x4000, the bf16 spec
   variant and a bf16 state copy at 4000x16000, the bf16 plain version,
   the slip and fast-math variants beside theirs;
15. the ext-halo forms of both kernels (the row-sharded path) against
   their plain versions (step_reference_ext) on meshes of 2 and 4
   virtual shards of the card, 10 single steps at the four scenes of
   phase 3, with the forcing guard off at column 0 on both sides of a
   shard boundary: float32 wall-free, plane, spec and slip, bf16 spec,
   ds fast and exact tiers, bitwise; fast math on 4 shards within
   FAST_MATH_RTOL of the IEEE single-chip plain version;
16. the sharded main paths on the 800x4000 reference scene, every launch
   counted: sharded-cuda over 1 and 4 virtual shards for WARMUP +
   MAIN_STEPS steps, bitwise equal to phase 4's cuda state;
   sharded-cuda-fused over 4 shards, FUSED_STEPS steps, and
   sharded-cuda-ds64 over 4 shards, DS_SHARDED_STEPS steps, bitwise
   equal to cuda and cuda-ds64; with two or more cards also a mesh of
   the cards;
17. times: us/step of each sharded path beside cuda and cuda-ds64, in
   turns, with the host's enqueue time; the halo exchange per step; the
   ext-halo kernels' launches of one step (interior + edges, or one per
   shard) beside the single-chip launch, as the host launches them and
   queued behind a spin (the card's own time), and their plain versions.

The kernels line gives every kernel's bound: the larger of its bytes
(each input read once, each output written once) over the card's
published memory rate and its f32 operations over the published f32
rate (PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S). The line before the last is
the card's name and power limit; the last is {"ok": true, "device":
{...}}. Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

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
# the sharded paths held against a single-chip path other than phase 4's
FUSED_STEPS = 1000
DS_SHARDED_STEPS = 2000
# virtual shards of one card on the sharded main paths (200-row shards)
VIRTUAL_SHARDS = 4
# the bound's denominators: one H100 SXM's published rates (NVIDIA's data
# sheet): HBM bytes per second and float32 operations per second outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations per site update: the reference's 124 FLOP for the
# stream-collide kernel; about 1.1k (fast tier) and 2.6k (exact) for the
# pair-DP kernel (csrc/lbm_ds_step.cu's header)
F32_OPS_PER_SITE = 124
DS_OPS_PER_SITE = {False: 1100, True: 2600}


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


def perturbed_state(cfg, rng):
    """Rest equilibrium times (1 + 5% uniform noise), as float32 (a bf16
    config's state is rounded to bf16 when it is loaded): non-zero
    velocities everywhere, so every term of the collision is exercised."""
    from latticeboltzmann_tpu_torch.models.engine import initial_state

    f = initial_state(cfg)
    return (f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))).astype(np.float32)


def reset_counts():
    """Every kernel launch count to 0."""
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel, fused_kernel

    fused_kernel.LAUNCHES = fused_ds_kernel.LAUNCHES = 0
    fused_kernel.EXT_LAUNCHES = fused_ds_kernel.EXT_LAUNCHES = 0
    fused_kernel.VARIANT_LAUNCHES.clear()
    fused_kernel.EXT_VARIANT_LAUNCHES.clear()


def read_counts():
    """{variant: launches} of the stream-collide kernel, its ext-halo
    form's as "ext-<variant>", and the ds kernel's under "ds" and
    "ds-ext"."""
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel, fused_kernel

    counts = dict(fused_kernel.VARIANT_LAUNCHES)
    if sum(counts.values()) != fused_kernel.LAUNCHES:
        raise AssertionError(f"variant counts {counts} != {fused_kernel.LAUNCHES} launches")
    ext = dict(fused_kernel.EXT_VARIANT_LAUNCHES)
    if sum(ext.values()) != fused_kernel.EXT_LAUNCHES:
        raise AssertionError(f"ext variant counts {ext} != {fused_kernel.EXT_LAUNCHES} launches")
    counts.update({f"ext-{v}": n for v, n in ext.items()})
    if fused_ds_kernel.LAUNCHES:
        counts["ds"] = fused_ds_kernel.LAUNCHES
    if fused_ds_kernel.EXT_LAUNCHES:
        counts["ds-ext"] = fused_ds_kernel.EXT_LAUNCHES
    return counts


def expect_counts(label, want):
    got = read_counts()
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected {want}")
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


def compare_kernel(name, cfg, geom, f0, steps=10):
    """Max |kernel - step_reference| over `steps` single steps, each
    from the same input (the kernel's previous output). geom: None (the
    wall-free variant), an (NX, NY) uint8 class plane, or a wall spec.
    Raises unless every step agrees bitwise."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import state_tensor

    dev = torch.device("cuda")
    g = on_card(geom, dev)
    a = state_tensor(f0, cfg.dtype, dev)
    b = torch.empty_like(a)
    err = 0.0
    for _ in range(steps):
        fused_kernel.step(a, b, g, cfg)
        ref = reference(a, g, cfg)
        d = (b.float() - ref.float()).abs()
        e = float(d.max())
        if not (torch.equal(b, ref) and e <= KERNEL_ATOL):
            bad = torch.nonzero(b != ref)
            per_speed = [float(d[s].max()) for s in range(9)]
            raise AssertionError(
                f"{name}: kernel != step_reference, max |diff| {e!r} at "
                f"{bad.shape[0]} values (first {bad[:5].tolist()}), per speed "
                f"{per_speed}"
            )
        err = max(err, e)
        a, b = b, a
    torch.cuda.synchronize()
    kind = "wall-free" if g is None else ("spec" if isinstance(g, tuple) else "plane")
    print(f"kernel vs step_reference {name} ({a.dtype}, {kind}), {steps} steps: "
          f"max |diff| = {err!r}")
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


def event_ms(fn, n):
    """Milliseconds per call of fn over n calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def queued_ms(fn, n, sleep_cycles=60_000_000):
    """Device milliseconds per call of fn over n calls: the card first
    spins for sleep_cycles (about 30 ms), long enough for the host to
    queue all n calls behind it, so the events time the launches back to
    back and not the host's launch rate (the sharded step's 12 small
    launches are host-bound, and event_ms would time the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


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


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.bench import card_info
    from latticeboltzmann_tpu_torch.ops import cuda_build, fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import bytes_per_site

    card = card_info()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    lib = cuda_build.build()
    cuda_build.load_library()
    print(f"build: {time.perf_counter() - t0:.3f} s -> {lib}")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "stack")):
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs its plain version
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    for name, cfg, w in scenes(np.float32):
        f0 = perturbed_state(cfg, rng)
        max_err = max(max_err, compare_kernel(name, cfg, w.astype(np.uint8), f0))
        max_err = max(max_err, compare_kernel(name, cfg, None, f0))

    # 4. the main path, every launch counted
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda")
    sim.run(WARMUP)
    sim.elapsed, sim.steps_done = 0.0, 0
    sim.run(MAIN_STEPS)
    launches = expect_counts("main path", {"f32-spec": WARMUP + MAIN_STEPS})["f32-spec"]
    f32_main = sim.state()
    re = sim.reynolds()
    if not (np.isfinite(f32_main).all() and (f32_main >= 0).all() and np.isfinite(re)):
        raise AssertionError(f"main path state not finite/non-negative, or Re {re!r}")
    print(f"main path: {MAIN_STEPS} steps (+{WARMUP} warmup) through backend=cuda, "
          f"wall spec {sim.wall_spec}, {launches} kernel launches, Re {re!r}, "
          f"{sim.mlups!r} MLUPS ({sim.elapsed!r} s)")
    runs = {}
    for backend in ("cuda", "torch"):
        runs[backend] = Simulation(cfg, walls, backend=backend, device="cuda").run(20).state()
    diff = np.abs(runs["cuda"] - runs["torch"])
    np.testing.assert_allclose(runs["cuda"], runs["torch"], rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    print(f"cuda vs torch backend after 20 steps: max |diff| {float(diff.max())!r} "
          f"(rtol {ENGINE_RTOL}, atol {ENGINE_ATOL})")

    # 5. times at 800x4000
    rates = rates_printer(cfg, bytes_per_site(cfg.dtype))
    rates("kernel main path, spec variant (slope 1680/5040 steps)", slope(sim))
    dev = torch.device("cuda")
    a = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    b = torch.empty_like(a)
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    spec = sim.wall_spec
    # the roofline's denominator: a device-to-device copy of one state
    # buffer moves the same 72 B per site as a step
    copy_ms = event_ms(lambda: b.copy_(a), 500)
    rates("device copy of the state, the bandwidth bound (CUDA events, 500 copies)",
          copy_ms * 1e-3)
    t = in_turns(rates, "kernel launch", {
        "plane variant": lambda: fused_kernel.step(a, b, solid, cfg),
        "spec variant": lambda: fused_kernel.step(a, b, spec, cfg),
    }, 500)
    plane_ms, kernel_ms = t["plane variant"], t["spec variant"]
    plain_ms = event_ms(lambda: fused_kernel.step_reference(a, solid, cfg), 20)
    rates("step_reference, its plain version (CUDA events, 20 steps)", plain_ms * 1e-3)
    eng = Simulation(cfg, walls, backend="torch", device="cuda")
    eng.run(5)
    eng.elapsed, eng.steps_done = 0.0, 0
    eng.run(200)
    rates("plain torch engine (200 steps)", eng.elapsed / 200)
    f32_entry = {
        "name": "lbm_stream_collide<float> (plane, wall-free, spec)",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1757",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "plane_ms": plane_ms,
        # the spec variant: 9 f32 values read and 9 written per site
        **bound(2 * a.numel() * a.element_size(), F32_OPS_PER_SITE * cfg.sites),
    }
    del sim, eng, a, b

    ds = ds_phases()
    options = option_phases(f32_main)
    ext = sharded_phases(f32_main)

    print(json.dumps({"kernels": [f32_entry, *options, ds, *ext]}))
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


def ds_phases():
    """Phases 6-8: the pair-DP kernel and path. Returns the ds kernel's
    entry of the kernels line."""
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

    # 7. the ds main path, every launch counted
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda-ds64")
    sim.run(WARMUP)
    sim.elapsed, sim.steps_done = 0.0, 0
    sim.run(MAIN_STEPS)
    launches = expect_counts("ds main path", {"ds": WARMUP + MAIN_STEPS})["ds"]
    f = sim.state()
    re = sim.reynolds()
    if not (f.dtype == np.float64 and np.isfinite(f).all() and (f >= 0).all()
            and np.isfinite(re)):
        raise AssertionError(f"ds main path state not finite/non-negative, or Re {re!r}")
    print(f"ds main path: {MAIN_STEPS} steps (+{WARMUP} warmup) through backend=cuda-ds64, "
          f"{launches} ds kernel launches, Re {re!r}, {sim.mlups!r} MLUPS ({sim.elapsed!r} s)")
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
    rates("ds main path, fast tier (slope 1680/5040 steps)", slope(sim))

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
    eng = Simulation(cfg, walls, backend="torch-ds64", device="cuda")
    eng.run(1)
    eng.elapsed, eng.steps_done = 0.0, 0
    eng.run(3)
    rates("eager torch-ds64 engine, exact tier (3 steps)", eng.elapsed / 3)
    return {
        "name": "lbm_stream_collide_ds",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_ds_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_ds_kernel.py:272",
        "launches": launches,
        "max_abs_err": max(max_err.values()),
        "ms": ms[False],
        "plain_ms": plain[False],
        "exact_tier_ms": ms[True],
        "exact_tier_plain_ms": plain[True],
        # the fast tier, masked: both pair components read and written,
        # and the mask byte
        **bound(4 * a.hi.numel() * 4 + solid.numel(), DS_OPS_PER_SITE[False] * cfg.sites),
    }


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
    MAIN_STEPS steps (phase 4). Returns the kernels line's entries for
    the bf16, slip and fast-math variant families."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry, initial_state
    from latticeboltzmann_tpu_torch.ops import fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import bytes_per_site, state_tensor

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    bf16 = "bfloat16"

    # 9. bf16 storage against its plain version, plane and wall-free
    bf16_err = 0.0
    for name, cfg, w in scenes(bf16):
        f0 = perturbed_state(cfg, rng)
        bf16_err = max(bf16_err, compare_kernel(name, cfg, w.astype(np.uint8), f0))
        bf16_err = max(bf16_err, compare_kernel(name, cfg, None, f0))

    # 10. the spec variant against the plane variant and step_reference
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
            if dtype == bf16:
                bf16_err = max(bf16_err, err)
            a = state_tensor(f0, cfg.dtype, dev)
            b, c = torch.empty_like(a), torch.empty_like(a)
            plane = torch.as_tensor(w.astype(np.uint8), device=dev)
            for _ in range(10):
                fused_kernel.step(a, b, spec, cfg)
                fused_kernel.step(a, c, plane, cfg)
                if not torch.equal(b, c):
                    raise AssertionError(f"{name} ({a.dtype}): spec variant != plane variant")
                a, b = b, a
            print(f"spec variant == plane variant, 800x4000 {name} ({a.dtype}), 10 steps")

    # 11. slip codes, bitwise, then the slip path through the facade
    slip_err = 0.0
    for nx, ny in ((24, 40), (800, 4000)):
        walls, slip_x, slip_y = slip_scene(nx, ny)
        cls = fused_kernel.class_plane(walls, slip_x, slip_y)
        for dtype in (np.float32, bf16):
            cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
            slip_err = max(slip_err, compare_kernel(
                f"{nx}x{ny} slip_x top row + slip_y block", cfg, cls,
                perturbed_state(cfg, rng)))
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    walls, slip_x, slip_y = slip_scene(800, 4000)
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda", slip_x=slip_x, slip_y=slip_y)
    sim.run(OPTION_STEPS)
    slip_launches = expect_counts("slip path", {"f32-plane-slip": OPTION_STEPS})["f32-plane-slip"]
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
    a = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    ref = a.clone()
    b = torch.empty_like(a)
    steps, bar = fused_kernel.FAST_MATH_STEPS, fused_kernel.FAST_MATH_RTOL
    for _ in range(steps):
        fused_kernel.step(a, b, spec, cfg, fast_math=True)
        a, b = b, a
        ref = fused_kernel.step_reference(ref, None, cfg, wall_spec=spec, fast_math=True)
    fast_abs = float((a - ref).abs().max())
    fast_rel = float(((a - ref).abs() / ref.abs()).max())
    if not fast_rel <= bar:
        raise AssertionError(f"fast math after {steps} steps: max rel {fast_rel!r} > {bar}")
    print(f"fast-math kernel vs step_reference (IEEE 1/rho) after {steps} chained steps: "
          f"max rel {fast_rel!r} (bar {bar}), max |diff| {fast_abs!r}, "
          f"{int((a != ref).sum())} of {a.numel()} values differ")
    reset_counts()
    sim = Simulation(cfg, walls, backend="cuda", fast_math=True)
    sim.run(OPTION_STEPS)
    fast_launches = expect_counts("fast-math path",
                                  {"f32-spec-fast": OPTION_STEPS})["f32-spec-fast"]
    f = sim.state()
    if not (np.isfinite(f).all() and (f >= 0).all()):
        raise AssertionError("fast-math path state not finite/non-negative")
    print(f"fast-math path: {OPTION_STEPS} steps through Simulation(fast_math=True, "
          f"backend=cuda), {fast_launches} launches, Re {sim.reynolds()!r}")

    # 13. the bf16 main path, every launch counted
    cfg16 = LatticeConfig(nx=800, ny=4000, dtype=bf16)
    reset_counts()
    sim = Simulation(cfg16, walls, backend="cuda")
    sim.run(WARMUP)
    sim.elapsed, sim.steps_done = 0.0, 0
    sim.run(MAIN_STEPS)
    bf16_launches = expect_counts("bf16 main path",
                                  {"bf16-spec": WARMUP + MAIN_STEPS})["bf16-spec"]
    f = sim.state()
    re = sim.reynolds()
    if not (f.dtype == np.float32 and np.isfinite(f).all() and (f >= 0).all()
            and np.isfinite(re)):
        raise AssertionError(f"bf16 main path state not finite/non-negative, or Re {re!r}")
    excess = np.abs(f - f32_main) - (BF16_ATOL + BF16_RTOL * np.abs(f32_main))
    print(f"bf16 main path: {MAIN_STEPS} steps (+{WARMUP} warmup) through backend=cuda, "
          f"{bf16_launches} kernel launches, Re {re!r}, {sim.mlups!r} MLUPS "
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

    # 14. times
    rates16 = rates_printer(cfg16, bytes_per_site(bf16))
    rates16("bf16 main path, spec variant (slope 1680/5040 steps)", slope(sim))
    del sim
    a = state_tensor(perturbed_state(cfg16, rng), bf16, dev)
    b = torch.empty_like(a)
    plane = torch.as_tensor(walls.astype(np.uint8), device=dev)
    copy16_ms = event_ms(lambda: b.copy_(a), 500)
    rates16("device copy of a bf16 state (CUDA events, 500 copies)", copy16_ms * 1e-3)
    t = in_turns(rates16, "bf16 kernel", {
        "plane variant": lambda: fused_kernel.step(a, b, plane, cfg16),
        "spec variant": lambda: fused_kernel.step(a, b, spec, cfg16),
    }, 500)
    bf16_plane_ms, bf16_ms = t["plane variant"], t["spec variant"]
    bf16_plain_ms = event_ms(lambda: fused_kernel.step_reference(a, None, cfg16,
                                                                 wall_spec=spec), 20)
    rates16("bf16 step_reference, its plain version (CUDA events, 20 steps)",
            bf16_plain_ms * 1e-3)
    del a, b

    big = LatticeConfig(nx=4000, ny=16000, dtype=bf16)
    big_spec = geometry.infer_spec(geometry.reference_barrier(4000, 16000))
    # the rest state: a timing input (the kernel's branches do not
    # depend on the values), made without 9 GB of host noise
    a = state_tensor(initial_state(big), bf16, dev)
    b = torch.empty_like(a)
    big_ms = event_ms(lambda: fused_kernel.step(a, b, big_spec, big), 50)
    big_copy_ms = event_ms(lambda: b.copy_(a), 50)
    rates_big = rates_printer(big, bytes_per_site(bf16))
    rates_big("bf16 kernel, spec variant, 4000x16000 (CUDA events, 50 launches)", big_ms * 1e-3)
    rates_big("device copy of a bf16 state, 4000x16000 (CUDA events, 50 copies)",
              big_copy_ms * 1e-3)
    del a, b

    rates = rates_printer(cfg, bytes_per_site(np.float32))
    a = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    b = torch.empty_like(a)
    walls_s, slip_x, slip_y = slip_scene(800, 4000)
    cls = torch.as_tensor(fused_kernel.class_plane(walls_s, slip_x, slip_y), device=dev)
    t = in_turns(rates, "f32 kernel", {
        "spec": lambda: fused_kernel.step(a, b, spec, cfg),
        "spec, fast math": lambda: fused_kernel.step(a, b, spec, cfg, fast_math=True),
        "plane with slip codes": lambda: fused_kernel.step(a, b, cls, cfg),
    }, 500)
    slip_plain_ms = event_ms(lambda: fused_kernel.step_reference(a, cls, cfg), 20)
    fast_plain_ms = event_ms(lambda: fused_kernel.step_reference(
        a, None, cfg, wall_spec=spec, fast_math=True), 20)
    rates("step_reference with slip codes (CUDA events, 20 steps)", slip_plain_ms * 1e-3)
    rates("step_reference, spec, IEEE 1/rho (CUDA events, 20 steps)", fast_plain_ms * 1e-3)

    source = "latticeboltzmann_tpu_torch/csrc/lbm_step.cu"
    replaces = "latticeboltzmann_tpu/ops/fused_kernel.py:1757"
    n_f = 9 * cfg.sites  # f values of one state at 800x4000
    ops = F32_OPS_PER_SITE * cfg.sites
    return [
        {"name": "lbm_stream_collide<__nv_bfloat16> (plane, wall-free, spec)",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": bf16_launches, "max_abs_err": bf16_err, "ms": bf16_ms,
         "plain_ms": bf16_plain_ms, "plane_ms": bf16_plane_ms,
         "ms_4000x16000": big_ms, **bound(2 * n_f * 2, ops)},
        {"name": "lbm_stream_collide<float, plane> with slip codes 2/3",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": slip_launches, "max_abs_err": slip_err,
         "ms": t["plane with slip codes"], "plain_ms": slip_plain_ms,
         **bound(2 * n_f * 4 + cls.numel(), ops)},
        {"name": "lbm_stream_collide<float, spec> fast math (rcp.approx.f32)",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": fast_launches, "max_abs_err": fast_abs, "max_rel_err": fast_rel,
         "ms": t["spec, fast math"], "plain_ms": fast_plain_ms, **bound(2 * n_f * 4, ops)},
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
    shards of the card, each shard held against step_reference_ext from
    the same input (bitwise, unless fast_math). geom: None, a host class
    plane, or a wall spec. Returns (joined state, max |diff|)."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel
    from latticeboltzmann_tpu_torch.utils.interop import state_tensor

    dev = torch.device("cuda")
    L = cfg.nx // n
    plane = isinstance(geom, np.ndarray)
    geoms = shard_planes(torch.as_tensor(geom, device=dev), n) if plane else [geom] * n
    f = state_tensor(f0, cfg.dtype, dev)
    err = 0.0
    for _ in range(steps):
        shards = [f[:, k * L:(k + 1) * L].contiguous() for k in range(n)]
        halos = ring_halos(shards)
        outs = []
        for k in range(n):
            dst = torch.full_like(shards[k], float("nan"))
            for call in ext_calls(fused_kernel.ext_launcher, L, shards[k], dst, halos[k],
                                  geoms[k], cfg=cfg, row_offset=k * L, fast_math=fast_math):
                call()
            ref = fused_kernel.step_reference_ext(shards[k], halos[k], geoms[k], cfg,
                                                  row_offset=k * L)
            d = (dst.float() - ref.float()).abs()
            e = float(d.max())
            if not fast_math and not (torch.equal(dst, ref) and e <= KERNEL_ATOL):
                bad = torch.nonzero(dst != ref)
                raise AssertionError(
                    f"{name}: ext-halo kernel != step_reference_ext on shard {k} of {n}, "
                    f"max |diff| {e!r} at {bad.shape[0]} values (first {bad[:5].tolist()})")
            err = max(err, e)
            outs.append(dst)
        f = torch.cat(outs, dim=1)
    torch.cuda.synchronize()
    kind = "wall-free" if geom is None else ("plane" if plane else "spec")
    print(f"ext-halo kernel vs step_reference_ext {name} ({f.dtype}, {kind}, "
          f"fast math {fast_math}), {n} virtual shards, {steps} steps: max |diff| = {err!r}")
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


def card_mesh_size(nx):
    """The most cards, at least 2, over which nx rows split evenly; 0 on a
    machine with one card."""
    return max((n for n in range(2, torch.cuda.device_count() + 1) if nx % n == 0), default=0)


def sharded_phases(f32_main):
    """Phases 15-17: the ext-halo kernels and the row-sharded paths.
    f32_main: phase 4's float32 state after WARMUP + MAIN_STEPS steps.
    Returns the kernels line's entries of the two ext-halo kernels."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry, initial_state
    from latticeboltzmann_tpu_torch.models import engine
    from latticeboltzmann_tpu_torch.ops import df64, fused_ds_kernel, fused_kernel
    from latticeboltzmann_tpu_torch.parallel import sharded
    from latticeboltzmann_tpu_torch.utils.interop import bytes_per_site, state_tensor

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 2)

    # 15. the ext-halo kernels against their plain versions
    ext_err = ds_ext_err = 0.0
    for name, cfg, w in scenes(np.float32):
        f0 = guard_off_at_boundaries(perturbed_state(cfg, rng), cfg.nx)
        slip_w, slip_x, slip_y = slip_scene(cfg.nx, cfg.ny)
        spec = geometry.infer_spec(w)
        geoms = {"wall-free": None, "plane": w.astype(np.uint8), "spec": spec,
                 "slip": fused_kernel.class_plane(slip_w, slip_x, slip_y)}
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        for n in (2, 4):
            for kind, g in geoms.items():
                ext_err = max(ext_err, compare_ext(f"{name}, {kind}", cfg, g, f0, n)[1])
            ext_err = max(ext_err, compare_ext(f"{name}, spec", cfg16, spec, f0, n)[1])
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

    # 16. the sharded main paths, every launch counted
    meshes = {"1 shard": sharded.make_mesh(devices=[dev]),
              f"{VIRTUAL_SHARDS} virtual shards": sharded.make_mesh(
                  devices=[dev] * VIRTUAL_SHARDS)}
    n_cards = card_mesh_size(cfg.nx)
    if n_cards:
        meshes[f"{n_cards} cards"] = sharded.make_mesh(n_cards)
    print(f"sharded meshes: {', '.join(f'{k} {[str(d) for d in m.devices]}' for k, m in meshes.items())}")
    sims = {}

    def launches_per_step(mesh, overlap=True):
        L = cfg.nx // mesh.size
        return mesh.size * (3 if overlap and L >= 3 else 1)

    def sharded_path(label, backend, make, mesh, cfg_, n_steps, key, per_step, want, warmup=0):
        """Register `backend` over `mesh`, drive it through Simulation for
        warmup + n_steps counted steps and hold its state bitwise to
        `want`."""
        engine.register_backend(backend, make(mesh))
        reset_counts()
        sim = Simulation(cfg_, walls, backend=backend)
        sim.run(warmup)
        sim.elapsed, sim.steps_done = 0.0, 0
        sim.run(n_steps)
        n = expect_counts(f"{backend} over {label}",
                          {key: (warmup + n_steps) * per_step})[key]
        got = sim.state()
        if not np.array_equal(got, want):
            raise AssertionError(f"{backend} over {label}: state != the single-chip path's after "
                                 f"{warmup + n_steps} steps, max |diff| "
                                 f"{float(np.abs(got - want).max())!r}")
        print(f"{backend} over {label}: {warmup + n_steps} steps, {n} counted ext-halo launches "
              f"({per_step} per step), bitwise equal to the single-chip path, Re "
              f"{sim.reynolds()!r}, {sim.mlups!r} MLUPS ({sim.elapsed!r} s)")
        sims[f"{backend}, {label}"] = sim
        return n

    key = f"ext-{fused_kernel.variant_name(torch.float32, 'spec', False, False)}"
    launches = {}
    for label, mesh in meshes.items():
        launches[label] = sharded_path(
            label, "sharded-cuda", lambda m: sharded.make_cuda_backend(m, overlap=True), mesh,
            cfg, MAIN_STEPS, key, launches_per_step(mesh), f32_main, warmup=WARMUP)
    want = Simulation(cfg, walls, backend="cuda").run(FUSED_STEPS).state()
    mesh4 = meshes[f"{VIRTUAL_SHARDS} virtual shards"]
    sharded_path(f"{VIRTUAL_SHARDS} virtual shards", "sharded-cuda-fused",
                 lambda m: sharded.make_cuda_backend(m, overlap=False), mesh4, cfg, FUSED_STEPS,
                 key, launches_per_step(mesh4, overlap=False), want)
    cfg64 = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    want = Simulation(cfg64, walls, backend="cuda-ds64").run(DS_SHARDED_STEPS).state()
    ds_launches = sharded_path(
        f"{VIRTUAL_SHARDS} virtual shards", "sharded-cuda-ds64", sharded.make_cuda_ds_backend,
        mesh4, cfg64, DS_SHARDED_STEPS, "ds-ext", launches_per_step(mesh4), want)
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
        """One step's halo copies from the session's plan, no launches."""
        copies = sess._plans[sess._parity][0]
        return lambda: (sess.exchange.start(copies), sess.exchange.finish())

    for label in (f"sharded-cuda, {VIRTUAL_SHARDS} virtual shards", ds_key):
        ms = event_ms(exchange_only(sims[label]._session), 500)
        print(f"halo exchange alone, {label}: {ms * 1e3!r} us/step (CUDA events, 500 exchanges)")
    del sims, f32_paths

    # the ext-halo kernels' launches of one step at the main path's
    # shapes, halos in place, beside the single-chip launch
    n, L = VIRTUAL_SHARDS, cfg.nx // VIRTUAL_SHARDS
    full = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    out = torch.empty_like(full)
    srcs = [full[:, k * L:(k + 1) * L].contiguous() for k in range(n)]
    dsts = [torch.empty_like(s) for s in srcs]
    halos = ring_halos(srcs)
    overlap_calls, fused_calls = [], []
    for k in range(n):
        overlap_calls += ext_calls(fused_kernel.ext_launcher, L, srcs[k], dsts[k], halos[k],
                                   spec, cfg=cfg, row_offset=k * L)
        fused_calls.append(fused_kernel.ext_launcher(srcs[k], dsts[k], halos[k], spec, cfg,
                                                     row_offset=k * L))
    # as the host launches them (event_ms), then the card's own time
    # (queued_ms), which the kernels line reports
    overlap = f"ext-halo, {n} shards, interior + edges ({len(overlap_calls)} launches)"
    group = {
        "single-chip kernel (1 launch)": lambda: fused_kernel.step(full, out, spec, cfg),
        overlap: lambda: [c() for c in overlap_calls],
        f"ext-halo, {n} shards, one launch per shard ({n})": lambda: [c() for c in fused_calls],
    }
    in_turns(rates, "f32 spec, one step's launches", group, 500)
    ext_ms = in_turns(rates, "f32 spec, one step's launches", group, 50, timer=queued_ms)[overlap]
    ext_plain_ms = event_ms(lambda: [fused_kernel.step_reference_ext(
        srcs[k], halos[k], spec, cfg, row_offset=k * L) for k in range(n)], 20)
    rates(f"step_reference_ext over {n} shards, its plain version (CUDA events, 20 steps)",
          ext_plain_ms * 1e-3)
    halo_bytes = sum(h.numel() * h.element_size() for pair in halos for h in pair)
    f32_bound = bound(2 * full.numel() * 4 + halo_bytes, F32_OPS_PER_SITE * cfg.sites)
    del full, out, srcs, dsts, halos, overlap_calls, fused_calls

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
    ds_calls = []
    for k in range(n):
        ds_calls += ext_calls(fused_ds_kernel.ext_launcher, L, srcs[k], dsts[k], halos[k],
                              planes[k], cfg=cfg64, has_walls=True)
    overlap = f"ext-halo, {n} shards, interior + edges ({len(ds_calls)} launches)"
    group = {
        "single-chip kernel (1 launch)": lambda: fused_ds_kernel.step(a, b, solid, cfg64,
                                                                      has_walls=True),
        overlap: lambda: [c() for c in ds_calls],
    }
    in_turns(rates64, "ds fast tier, one step's launches", group, 200)
    ds_ext_ms = in_turns(rates64, "ds fast tier, one step's launches", group, 50,
                         timer=queued_ms)[overlap]
    ds_ext_plain_ms = event_ms(lambda: [fused_ds_kernel.step_reference_ext(
        srcs[k].hi, srcs[k].lo, halos[k], planes[k], cfg64, False) for k in range(n)], 3)
    rates64(f"ds step_reference_ext over {n} shards, its plain version (CUDA events, 3 steps)",
            ds_ext_plain_ms * 1e-3)
    # halo rows: both components of each, and their class rows
    halo_bytes = sum(c.numel() * 4 for h in halos for pair in h for c in pair)
    halo_bytes += sum(p.top.numel() + p.bot.numel() for p in planes)
    ds_bound = bound(4 * a.hi.numel() * 4 + solid.numel() + halo_bytes,
                     DS_OPS_PER_SITE[False] * cfg64.sites)

    label4 = f"{VIRTUAL_SHARDS} virtual shards"
    return [
        {"name": "lbm_stream_collide<float, spec> ext-halo form (row-sharded; "
                 f"{VIRTUAL_SHARDS} virtual shards, interior + edge launches)",
         "route": "cuda", "source": "latticeboltzmann_tpu_torch/csrc/lbm_step.cu",
         "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1757",
         "launches": launches[label4], "max_abs_err": ext_err, "max_rel_err_fast_math": fast_rel,
         "ms": ext_ms, "plain_ms": ext_plain_ms, **f32_bound},
        {"name": "lbm_stream_collide_ds ext-halo form (row-sharded; "
                 f"{VIRTUAL_SHARDS} virtual shards, fast tier, masked)",
         "route": "cuda", "source": "latticeboltzmann_tpu_torch/csrc/lbm_ds_step.cu",
         "replaces": "latticeboltzmann_tpu/ops/fused_ds_kernel.py:272",
         "launches": ds_launches, "max_abs_err": ds_ext_err,
         "ms": ds_ext_ms, "plain_ms": ds_ext_plain_ms, **ds_bound},
    ]


if __name__ == "__main__":
    sys.exit(main())
