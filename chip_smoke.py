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
   the slip and fast-math variants beside theirs.

The line before the last is the card's name and power limit; the last
is {"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

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
    fused_kernel.VARIANT_LAUNCHES.clear()


def read_counts():
    """{variant: launches} of the stream-collide kernel, and the ds
    kernel's under "ds"."""
    from latticeboltzmann_tpu_torch.ops import fused_ds_kernel, fused_kernel

    counts = dict(fused_kernel.VARIANT_LAUNCHES)
    if sum(counts.values()) != fused_kernel.LAUNCHES:
        raise AssertionError(f"variant counts {counts} != {fused_kernel.LAUNCHES} launches")
    if fused_ds_kernel.LAUNCHES:
        counts["ds"] = fused_ds_kernel.LAUNCHES
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


def in_turns(rates, prefix, fns, n):
    """Time each labelled fn by CUDA events over n calls, in turns a, b,
    ..., ..., b, a; print every time in the order taken and return
    {label: best ms}."""
    order = list(fns) + list(reversed(fns))
    best = {}
    for label in order:
        ms = event_ms(fns[label], n)
        rates(f"{prefix}, {label} (CUDA events, {n} calls, in turns)", ms * 1e-3)
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
    }
    del sim, eng, a, b

    ds = ds_phases()
    options = option_phases(f32_main)

    print(json.dumps({"kernels": [f32_entry, *options, ds]}))
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
    return [
        {"name": "lbm_stream_collide<__nv_bfloat16> (plane, wall-free, spec)",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": bf16_launches, "max_abs_err": bf16_err, "ms": bf16_ms,
         "plain_ms": bf16_plain_ms, "plane_ms": bf16_plane_ms,
         "ms_4000x16000": big_ms},
        {"name": "lbm_stream_collide<float, plane> with slip codes 2/3",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": slip_launches, "max_abs_err": slip_err,
         "ms": t["plane with slip codes"], "plain_ms": slip_plain_ms},
        {"name": "lbm_stream_collide<float, spec> fast math (rcp.approx.f32)",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": fast_launches, "max_abs_err": fast_abs, "max_rel_err": fast_rel,
         "ms": t["spec, fast math"], "plain_ms": fast_plain_ms},
    ]


if __name__ == "__main__":
    sys.exit(main())
