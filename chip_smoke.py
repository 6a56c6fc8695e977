"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure:
1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles csrc/lbm_step.cu with nvcc (timed);
3. the stream-collide kernel against its plain PyTorch version
   (fused_kernel.step_reference) on the card, one step at a time from
   identical inputs, at four scenes; they must agree bitwise;
4. the main path: Simulation(backend="cuda") on the 800x4000 reference
   scene for 10,000 steps after a warmup, every step a counted kernel
   launch; the state must be finite and non-negative and Re finite, and
   a 20-step run must match the "torch" backend on the same card;
5. times of the kernel, its plain version, the plain "torch" engine and
   a device copy of the state (the bandwidth bound) at 800x4000;
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
   the eager "torch-ds64" engine, and the ds main path's slope.

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
# the kernel is built with -fmad=false and IEEE division, so it rounds
# exactly like step_reference: bitwise agreement is the bar
KERNEL_ATOL = 0.0
# the JAX package's pallas-vs-xla bar after 20 steps
# (tests/test_pallas.py:74-81): the two engines associate differently
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-7
# the JAX package's pair-DP bar: the fast tier against a float64 engine
# after 200 steps (tests/test_ds.py:213-229)
DS_RTOL = 1e-11
DS_COMPARE_STEPS = 200


def perturbed_state(cfg, rng):
    """Rest equilibrium times (1 + 5% uniform noise): non-zero velocities
    everywhere, so every term of the collision is exercised."""
    from latticeboltzmann_tpu_torch.models.engine import initial_state

    f = initial_state(cfg)
    return (f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))).astype(np.float32)


def compare_kernel(name, cfg, walls, f0, steps=10):
    """Max |kernel - step_reference| over `steps` single steps, each
    from the same input (the kernel's previous output)."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel

    dev = torch.device("cuda")
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    has_walls = bool(walls.any())
    a = torch.as_tensor(f0, device=dev)
    b = torch.empty_like(a)
    err = 0.0
    for _ in range(steps):
        fused_kernel.step(a, b, solid, cfg, has_walls=has_walls)
        ref = fused_kernel.step_reference(a, solid if has_walls else None, cfg)
        d = (b - ref).abs()
        e = float(d.max())
        if not e <= KERNEL_ATOL:
            bad = torch.nonzero(d > KERNEL_ATOL)
            per_speed = [float(d[s].max()) for s in range(9)]
            raise AssertionError(
                f"{name}: kernel != step_reference, max |diff| {e!r} at "
                f"{bad.shape[0]} values (first {bad[:5].tolist()}), per speed "
                f"{per_speed}"
            )
        err = max(err, e)
        a, b = b, a
    torch.cuda.synchronize()
    print(f"kernel vs step_reference {name} ({'masked' if has_walls else 'wall-free'}), "
          f"{steps} steps: max |diff| = {err!r}")
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


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.bench import card_info
    from latticeboltzmann_tpu_torch.core.spec import bytes_per_site_update
    from latticeboltzmann_tpu_torch.ops import cuda_build, fused_ds_kernel, fused_kernel

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
    scenes = []
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    w = geometry.channel(16, 40)
    w[5:9, 10:13] = True
    scenes.append(("16x40 channel+barrier", cfg, w))
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32, accel=0.005)
    w = geometry.channel(24, 40)
    w[8:14, 0:3] = True
    scenes.append(("24x40 walls on columns 0-2", cfg, w))
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    scenes.append(("16x40 empty box", cfg, geometry.empty(16, 40)))
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    scenes.append(("800x4000 reference_barrier", cfg, geometry.reference_barrier(800, 4000)))
    max_err = 0.0
    for name, cfg, w in scenes:
        max_err = max(max_err, compare_kernel(name, cfg, w, perturbed_state(cfg, rng)))

    # 4. the main path, every launch counted
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float32)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    fused_kernel.LAUNCHES = fused_ds_kernel.LAUNCHES = 0
    sim = Simulation(cfg, walls, backend="cuda")
    sim.run(WARMUP)
    sim.elapsed, sim.steps_done = 0.0, 0
    sim.run(MAIN_STEPS)
    launches, ds_stray = fused_kernel.LAUNCHES, fused_ds_kernel.LAUNCHES
    if launches != WARMUP + MAIN_STEPS or ds_stray:
        raise AssertionError(f"main path made {launches} launches for {WARMUP + MAIN_STEPS} "
                             f"steps, and {ds_stray} ds kernel launches")
    f = sim.state()
    re = sim.reynolds()
    if not (np.isfinite(f).all() and (f >= 0).all() and np.isfinite(re)):
        raise AssertionError(f"main path state not finite/non-negative, or Re {re!r}")
    print(f"main path: {MAIN_STEPS} steps (+{WARMUP} warmup) through backend=cuda, "
          f"{launches} kernel launches, Re {re!r}, {sim.mlups!r} MLUPS "
          f"({sim.elapsed!r} s)")
    runs = {}
    for backend in ("cuda", "torch"):
        runs[backend] = Simulation(cfg, walls, backend=backend, device="cuda").run(20).state()
    diff = np.abs(runs["cuda"] - runs["torch"])
    np.testing.assert_allclose(runs["cuda"], runs["torch"], rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    print(f"cuda vs torch backend after 20 steps: max |diff| {float(diff.max())!r} "
          f"(rtol {ENGINE_RTOL}, atol {ENGINE_ATOL})")

    # 5. times at 800x4000
    bps = bytes_per_site_update(np.float32)

    def rates(label, sec_per_step):
        mlups = cfg.sites / sec_per_step / 1e6
        print(f"{label}: {sec_per_step * 1e6!r} us/step, {mlups!r} MLUPS, "
              f"{mlups * 1e6 * bps / 1e9!r} GB/s effective")

    def timed(n):
        sim.elapsed, sim.steps_done = 0.0, 0
        sim.run(n)
        return sim.elapsed

    n1, n2 = 1680, 5040
    timed(n1)
    t1 = min(timed(n1) for _ in range(2))
    t2 = min(timed(n2) for _ in range(2))
    rates("kernel main path (slope 1680/5040 steps)", (t2 - t1) / (n2 - n1))

    dev = torch.device("cuda")
    a = torch.as_tensor(perturbed_state(cfg, rng), device=dev)
    b = torch.empty_like(a)
    solid = torch.as_tensor(walls.astype(np.uint8), device=dev)
    kernel_ms = event_ms(lambda: fused_kernel.step(a, b, solid, cfg, has_walls=True), 500)
    plain_ms = event_ms(lambda: fused_kernel.step_reference(a, solid, cfg), 20)
    # the roofline's denominator: a device-to-device copy of one state
    # buffer moves the same 72 B per site as a step
    copy_ms = event_ms(lambda: b.copy_(a), 500)
    rates("device copy of the state, the bandwidth bound (CUDA events, 500 copies)",
          copy_ms * 1e-3)
    rates("kernel launch (CUDA events, 500 launches)", kernel_ms * 1e-3)
    rates("step_reference, its plain version (CUDA events, 20 steps)", plain_ms * 1e-3)
    eng = Simulation(cfg, walls, backend="torch", device="cuda")
    eng.run(5)
    eng.elapsed, eng.steps_done = 0.0, 0
    eng.run(200)
    rates("plain torch engine (200 steps)", eng.elapsed / 200)

    ds = ds_phases()

    print(json.dumps({"kernels": [{
        "name": "lbm_stream_collide_f32",
        "route": "cuda",
        "source": "latticeboltzmann_tpu_torch/csrc/lbm_step.cu",
        "replaces": "latticeboltzmann_tpu/ops/fused_kernel.py:1757",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, ds]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def ds_phases():
    """Phases 6-8: the pair-DP kernel and path. Returns the ds kernel's
    entry of the kernels line."""
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.models.engine import initial_state
    from latticeboltzmann_tpu_torch.ops import df64, fused_ds_kernel, fused_kernel

    # 6. the ds kernel vs its plain version, both tiers and both variants
    rng = np.random.default_rng(SEED)
    scenes = []
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    w = geometry.channel(16, 40)
    w[5:9, 10:13] = True
    scenes.append(("16x40 channel+barrier", cfg, w))
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float64, accel=0.005)
    w = geometry.channel(24, 40)
    w[8:14, 0:3] = True
    scenes.append(("24x40 walls on columns 0-2", cfg, w))
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    scenes.append(("16x40 empty box", cfg, geometry.empty(16, 40)))
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    scenes.append(("800x4000 reference_barrier", cfg, geometry.reference_barrier(800, 4000)))
    max_err = {False: 0.0, True: 0.0}
    for name, cfg, w in scenes:
        f = initial_state(cfg)
        f0 = f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))
        for exact in (False, True):
            max_err[exact] = max(max_err[exact], compare_ds_kernel(name, cfg, w, f0, exact))

    # 7. the ds main path, every launch counted
    cfg = LatticeConfig(nx=800, ny=4000, dtype=np.float64)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    fused_kernel.LAUNCHES = fused_ds_kernel.LAUNCHES = 0
    sim = Simulation(cfg, walls, backend="cuda-ds64")
    sim.run(WARMUP)
    sim.elapsed, sim.steps_done = 0.0, 0
    sim.run(MAIN_STEPS)
    launches, f32_stray = fused_ds_kernel.LAUNCHES, fused_kernel.LAUNCHES
    if launches != WARMUP + MAIN_STEPS or f32_stray:
        raise AssertionError(f"ds main path made {launches} ds launches for "
                             f"{WARMUP + MAIN_STEPS} steps, and {f32_stray} f32 launches")
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
    bps = fused_ds_kernel.BYTES_PER_SITE_DS

    def rates(label, sec_per_step):
        mlups = cfg.sites / sec_per_step / 1e6
        print(f"{label}: {sec_per_step * 1e6!r} us/step, {mlups!r} MLUPS, "
              f"{mlups * 1e6 * bps / 1e9!r} GB/s effective ({bps} B/site)")

    def timed(n):
        sim.elapsed, sim.steps_done = 0.0, 0
        sim.run(n)
        return sim.elapsed

    n1, n2 = 1680, 5040
    timed(n1)
    t1 = min(timed(n1) for _ in range(2))
    t2 = min(timed(n2) for _ in range(2))
    rates("ds main path, fast tier (slope 1680/5040 steps)", (t2 - t1) / (n2 - n1))

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


if __name__ == "__main__":
    sys.exit(main())
