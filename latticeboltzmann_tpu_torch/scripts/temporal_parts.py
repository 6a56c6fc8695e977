"""The local temporal pass taken apart on a CUDA card, the CTA designs
measured against it, and the pass against another checkout's build.

Row 1-T of the port (csrc/lbm_temporal_step.cu's lbm_temporal_steps, the
main path's pass of L steps: two CTAs of 256 threads an SM, one tile
buffer each, the card's tile, each tile's rows loaded as two groups of
copies and its first level run on the top rows while the bottom rows
land) is timed with the reference barrier beside the measurement kernels
of temporal_parts.cu (built here from that file and the port's headers,
with the port's flags; the port never calls them):

  parts    at 800x4000 (wall spec): the pass; a tile's bytes alone (its
           loads, then a store of its output tile); its levels alone on a
           resident tile at 2 CTAs of 256 threads an SM, 2 of 512, one of
           512 and of 1,024, two sites a thread at 2 x 256, 1 x 512 and
           2 x 512, and at 2 x 256 without the per-level barriers (timing
           only): f32 L = 3, 6 and bf16 L = 2, 6
  designs  at 800x4000: the pass against the double-buffered CTA (one CTA
           an SM, two tile buffers, the next tile's copies under the
           current tile's levels) at 512 and 1,024 threads and two sites a
           thread; the tile loaded as one group and then its levels, at 2
           CTAs of 256 and of 512 threads an SM; the pass's body with four
           bands of rows at 2 x 256 and 2 x 512; each at its tile plan
           (plan_tiles over the lattice's rows) or the card's tile, and
           four of them at forced tile heights: f32 L = 3, 4, 6 and bf16 L
           = 2, 3, 6
  sweep    at 800x4000: the pass against the tile loaded as one group (2 x
           256, the card's tile) and the double-buffered 512-thread CTA at
           its plan, at T = 1, 2, 3, 4, 6, 8 and the deepest, f32 and bf16
  compare  with --parent DIR (a checkout of another commit, e.g. a git
           archive unpacked there): that checkout's kernel library, built
           from its csrc/, against this one's: every kernel's SASS
           (utils/sass.digests), and the pass through fused_kernel.
           temporal_step with either library in turns at 800x4000 (spec at
           T = 1, 2, 3, 4, 6, 8 and the deepest, plane at f32 T = 3, 6 and
           bf16 T = 2, 6), 4000x16000 bf16 (spec, T = 3, 4, 6) and
           400x2000 f32 (spec, T = 6), bitwise to each other; and the main
           path, Simulation(reference_barrier(800, 4000), backend="cuda",
           temporal=6) for WARMUP + MAIN_STEPS steps in f32 and bf16, by
           the host clock, its states bitwise equal
  all      every section above (compare only with --parent)

Every launch is queued behind a spin (utils.timing.queued_ms) and every
list of launches runs in turns, forward then reversed; a line gives the
best and worst of its runs in us a pass, with the launch's registers,
CTAs an SM, spills, tile rows, CTAs and the tiles its busiest CTA walks.
Every design's output is held bitwise against the pass's (each computes
the same sites with the same arithmetic). The first line printed is the
card's name and power limit. Without a CUDA card the script exits 2.

Usage:  python -m latticeboltzmann_tpu_torch.scripts.temporal_parts
            [--section all] [--runs 20] [--parent DIR]
            [--out chiprun_out/temporal_parts.json]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

SECTIONS = ("all", "parts", "designs", "sweep", "compare")
SOURCE = pathlib.Path(__file__).with_name("temporal_parts.cu")
NX, NY = 800, 4000
# the passes of each section: (storage, L)
PARTS_PASSES = (("f32", 3), ("f32", 6), ("bf16", 2), ("bf16", 6))
DESIGN_PASSES = (("f32", 3), ("f32", 4), ("f32", 6), ("bf16", 2), ("bf16", 3), ("bf16", 6))
SWEEP_DEPTHS = (1, 2, 3, 4, 6, 8)
# the compare section's other lattices: (nx, ny, storage, depths), and the
# main path's depth and steps (chip_smoke.py's WARMUP + MAIN_STEPS)
COMPARE_OTHERS = ((4000, 16000, "bf16", (3, 4, 6)), (400, 2000, "f32", (6,)))
MAIN_PATH_T = 6
MAIN_PATH_STEPS = 10_096
# temporal_parts.cu's kernels: (kind, variant) -> what it is
BYTES_ALONE = {(0, 0): "bytes alone (2 CTAs of 256 an SM)"}
LEVELS_ALONE = {(1, 0): "levels alone, 2 CTAs of 256 an SM",
                (1, 1): "levels alone, 2 CTAs of 512 an SM",
                (1, 2): "levels alone, 1 CTA of 1024",
                (1, 3): "levels alone, 2 CTAs of 256, two sites a thread",
                (1, 4): "levels alone, 2 CTAs of 256, no per-level barrier",
                (1, 5): "levels alone, 1 CTA of 512",
                (1, 6): "levels alone, 1 CTA of 512, two sites a thread",
                (1, 7): "levels alone, 2 CTAs of 512, two sites a thread"}
BUFFERED = {(2, 0): "buffered, 1 CTA of 512",
            (2, 1): "buffered, 1 CTA of 1024",
            (2, 2): "buffered, 1 CTA of 512, two sites a thread",
            (2, 3): "buffered, 1 CTA of 256, two sites a thread"}
SINGLE = {(3, 0): "one group, 2 CTAs of 256 an SM",
          (3, 1): "one group, 2 CTAs of 512 an SM"}
BANDED = {(4, 0): "4 bands, 2 CTAs of 256 an SM, the card's tile",
          (4, 1): "4 bands, 2 CTAs of 512 an SM, the card's tile",
          (4, 2): "4 bands, 2 CTAs of 256 an SM"}
DESIGNS = {**BUFFERED, **SINGLE, **BANDED}
# the designs swept over forced tile heights
FORCED = ((3, 0), (3, 1), (2, 0), (4, 2))
PASS = "the pass (lbm_temporal_steps)"


def _nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """temporal_parts.cu built into build/temporal_parts/<hash>/ with the
    port's nvcc flags and headers (at first use), loaded."""
    from latticeboltzmann_tpu_torch.ops import cuda_build

    h = hashlib.sha256(" ".join(cuda_build.NVCC_FLAGS).encode() + SOURCE.read_bytes())
    for name in cuda_build.HEADERS:
        h.update((cuda_build.CSRC / name).read_bytes())
    out = cuda_build.build_dir().parent.parent / "temporal_parts" / h.hexdigest()[:16]
    lib = out / "libtemporal_parts.so"
    if not lib.is_file():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"libtemporal_parts.{os.getpid()}.tmp"
        r = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
                            "-I", str(cuda_build.CSRC), "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True, timeout=600)
        (out / "nvcc.log").write_text(r.stdout + r.stderr)
        if r.returncode:
            raise RuntimeError(f"nvcc failed with code {r.returncode}:\n{r.stdout}{r.stderr}")
        tmp.replace(lib)
    fn = ctypes.CDLL(str(lib)).temporal_parts_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    return fn


class Pass:
    """One pass of L steps of storage `st` on an (nx, ny) lattice with the
    reference barrier as a wall spec or a class plane (kind): the port's
    kernel and every measurement kernel on the same input."""

    def __init__(self, st: str, L: int, seed: int, nx: int = NX, ny: int = NY,
                 kind: str = "spec"):
        from latticeboltzmann_tpu_torch import LatticeConfig, geometry
        from latticeboltzmann_tpu_torch.models.engine import initial_state
        from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
        from latticeboltzmann_tpu_torch.utils.interop import state_tensor

        self.fk, self.st, self.L, self.kind = fk, st, L, kind
        dtype = np.float32 if st == "f32" else "bfloat16"
        self.cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
        rng = np.random.default_rng(seed)
        f0 = initial_state(self.cfg)
        f0 = (f0 * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f0.shape))).astype(np.float32)
        self.f = state_tensor(f0, dtype, "cuda")
        walls = geometry.reference_barrier(nx, ny)
        self.spec = geometry.infer_spec(walls)
        self.geom = (self.spec if kind == "spec" else
                     torch.as_tensor(walls.astype(np.uint8), device="cuda"))
        self.params = (ctypes.c_float * 9)(*fk.kernel_constants(self.cfg))
        self.kspec = (ctypes.c_int64 * fk.SPEC_FIELDS)(*fk.kernel_spec(self.spec, nx, ny))
        self.storage = 0 if st == "f32" else 1
        self.info = fk.temporal_info(self.f.dtype, kind)

    def port(self, dst):
        self.fk.temporal_step(self.f, dst, self.geom, self.cfg, self.L)

    def launch(self, key, dst, tile_rows=0) -> list[int]:
        """One launch of temporal_parts.cu's kernel `key` (kind, variant;
        the spec variant); its registers, CTAs/SM, shared bytes, local
        bytes, tile rows, CTAs and waves."""
        out = (ctypes.c_int64 * 7)()
        rc = _library()(key[0], key[1], self.storage, self.f.data_ptr(), dst.data_ptr(),
                        ctypes.addressof(self.kspec), self.cfg.nx, self.cfg.ny, self.L,
                        ctypes.addressof(self.params), tile_rows, ctypes.addressof(out),
                        torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"temporal_parts_launch{key} at tile_rows {tile_rows}: "
                               f"cudaError {rc}")
        return list(out)

    def run(self, cases, runs, check, fns=None) -> dict:
        """Time the port's pass and `cases` ({label: (key, tile_rows)}) or
        `fns` ({label: a call writing into its buffer}) in turns. check:
        hold each one's output bitwise against the pass's. Prints a line
        each; returns {label: {"us": [...], "shape": [...]}}."""
        from latticeboltzmann_tpu_torch.utils.timing import queued_ms

        ref = torch.full_like(self.f, float("nan"))
        self.port(ref)
        i = self.info
        calls = {PASS: lambda: self.port(ref)}
        shapes = {PASS: [i["registers"], i["ctas_per_sm"], i["shared_bytes_per_cta"],
                         i["local_bytes"], i["rows"], None, None]}
        outs = {}
        for label, (key, rows) in cases.items():
            outs[label] = torch.full_like(self.f, float("nan"))
            shapes[label] = self.launch(key, outs[label], rows)
            calls[label] = functools.partial(self.launch, key, outs[label], rows)
        for label, fn in (fns or {}).items():
            outs[label] = torch.full_like(self.f, float("nan"))
            fn(outs[label])
            shapes[label] = None
            calls[label] = functools.partial(fn, outs[label])
        bits = torch.int16 if self.storage else torch.int32
        for label, buf in outs.items():
            if check and not torch.equal(buf.view(bits), ref.view(bits)):
                raise AssertionError(f"{self.st} L={self.L} {label}: not bitwise the pass's")
        times = {label: [] for label in calls}
        for label in list(calls) + list(reversed(list(calls))):
            times[label].append(queued_ms(calls[label], runs) * 1e3)
        name = f"{self.st} {self.cfg.nx}x{self.cfg.ny} {self.kind} L={self.L}"
        out = {}
        for label, us in times.items():
            line = (f"{name} {label}: {min(us):.2f}-{max(us):.2f} us a pass "
                    f"({min(us) / self.L:.2f} us/step)")
            if shapes[label] is not None:
                regs, per_sm, _, local, rows, ctas, waves = shapes[label]
                line += (f"; {regs} registers, {per_sm} CTA(s)/SM, {local} B local, tile rows "
                         f"{rows}" + (f", {ctas} CTAs, the busiest walking {waves} tiles"
                                      if ctas else ""))
            print(line)
            out[label] = {"us": us, "shape": shapes[label]}
        if check:
            print(f"{name}: {len(outs)} launches bitwise to the pass")
        return out


def _label(key) -> str:
    """A design's label at tile_rows 0: at the card's tile, or planned."""
    label = DESIGNS[key]
    return label if "card's tile" in label else f"{label}, planned"


def parts(runs: int) -> dict:
    res = {}
    for i, (st, L) in enumerate(PARTS_PASSES):
        p = Pass(st, L, seed=i)
        cases = {label: (key, 0) for key, label in {**BYTES_ALONE, **LEVELS_ALONE}.items()}
        res[f"{st} L={L}"] = p.run(cases, runs, check=False)
    return res


def designs(runs: int) -> dict:
    res = {}
    for i, (st, L) in enumerate(DESIGN_PASSES):
        p = Pass(st, L, seed=10 + i)
        card = p.info["rows"]
        lo, step = (card - 12, 1) if st == "f32" else (card - 30, 3)
        heights = sorted({*range(max(lo, 2 * L + 1), card + 1, step), card})
        cases = {_label(key): (key, 0) for key in DESIGNS}
        for key in FORCED:
            label = DESIGNS[key].replace(", the card's tile", "")
            cases.update({f"{label}, {rows} rows": (key, rows) for rows in heights})
        res[f"{st} L={L}"] = p.run(cases, runs, check=True)
        torch.cuda.empty_cache()
    return res


def _depths(st: str) -> tuple[int, ...]:
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

    dtype = torch.float32 if st == "f32" else torch.bfloat16
    return (*SWEEP_DEPTHS, fk.temporal_info(dtype)["max_steps"])


def sweep(runs: int) -> dict:
    res = {}
    for st in ("f32", "bf16"):
        for L in _depths(st):
            p = Pass(st, L, seed=20 + L)
            cases = {f"{SINGLE[(3, 0)]}, the card's tile": ((3, 0), p.info["rows"]),
                     _label((2, 0)): ((2, 0), 0)}
            res[f"{st} L={L}"] = p.run(cases, runs, check=True)
    return res


def _build_checkout(root: pathlib.Path) -> pathlib.Path:
    """The kernel library of another checkout of the port, built from its
    csrc/ by its own ops/cuda_build.py into its build/ (a process of its
    own, so that the two packages of one name never meet)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from latticeboltzmann_tpu_torch.ops import cuda_build; print(cuda_build.build())")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True,
                         check=True, timeout=900).stdout
    return pathlib.Path(out.strip().splitlines()[-1])


@contextlib.contextmanager
def _using(lib):
    """fused_kernel's launches go to `lib` (a loaded kernel library)."""
    from latticeboltzmann_tpu_torch.ops import cuda_build

    old = cuda_build.load_library
    cuda_build.load_library = lambda: lib
    try:
        yield
    finally:
        cuda_build.load_library = old


def compare(runs: int, parent: pathlib.Path) -> dict:
    from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
    from latticeboltzmann_tpu_torch.ops import cuda_build
    from latticeboltzmann_tpu_torch.utils import sass

    mine = cuda_build.load_library()
    path = _build_checkout(parent)
    build = cuda_build.build
    cuda_build.build = lambda: path
    try:
        theirs = cuda_build.load_library.__wrapped__()  # the same entry points, declared
    finally:
        cuda_build.build = build
    a = sass.digests(sass.disassemble(path))
    b = sass.digests(sass.disassemble(cuda_build.build()))
    differ = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
    print(f"SASS against {parent}: {len(b)} kernels here, {len(a)} there, "
          f"{len(a.keys() & b.keys())} in both; {len(differ)} differ: {differ}; only here "
          f"{sorted(b.keys() - a.keys())}, only there {sorted(a.keys() - b.keys())}")
    res = {"sass": {"kernels": len(b), "differ": differ}}

    def pair(p: Pass) -> dict:
        def parent_pass(dst):
            with _using(theirs):
                p.port(dst)

        return p.run({}, runs, check=True, fns={"the parent's pass": parent_pass})

    for st in ("f32", "bf16"):
        for L in _depths(st):
            res[f"{st} 800x4000 spec L={L}"] = pair(Pass(st, L, seed=30 + L))
        for L in ((3, 6) if st == "f32" else (2, 6)):
            res[f"{st} 800x4000 plane L={L}"] = pair(Pass(st, L, seed=40 + L, kind="plane"))
    for nx, ny, st, depths in COMPARE_OTHERS:
        for L in depths:
            res[f"{st} {nx}x{ny} spec L={L}"] = pair(Pass(st, L, seed=50 + L, nx=nx, ny=ny))
            torch.cuda.empty_cache()
    walls = geometry.reference_barrier(NX, NY)
    for st, dtype in (("f32", np.float32), ("bf16", "bfloat16")):
        cfg = LatticeConfig(nx=NX, ny=NY, dtype=dtype)
        times, states = {"the pass": [], "the parent's pass": []}, {}
        for label in ("the parent's pass", "the pass", "the pass", "the parent's pass"):
            with _using(theirs if label == "the parent's pass" else mine):
                sim = Simulation(cfg, walls, backend="cuda", temporal=MAIN_PATH_T)
                sim.run(MAIN_PATH_STEPS)
                times[label].append(sim.elapsed / MAIN_PATH_STEPS * 1e6)
                states[label] = sim.state()
        same = np.array_equal(states["the pass"], states["the parent's pass"])
        if not same:
            raise AssertionError(f"{st} main path: the states of the two builds differ")
        for label, us in times.items():
            print(f"{st} main path, Simulation(reference_barrier(800, 4000), backend=cuda, "
                  f"temporal={MAIN_PATH_T}), {MAIN_PATH_STEPS} steps, {label}: "
                  f"{min(us):.2f}-{max(us):.2f} us/step by the host clock")
        print(f"{st} main path: the two builds' states bitwise equal")
        res[f"{st} main path"] = times
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m latticeboltzmann_tpu_torch.scripts.temporal_parts",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--section", choices=SECTIONS, default="all")
    ap.add_argument("--runs", type=int, default=20, help="launches queued a timed run")
    ap.add_argument("--parent", type=pathlib.Path,
                    help="another checkout of the repository to compare against (compare)")
    ap.add_argument("--out", type=pathlib.Path, help="write every run's times as JSON")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.section == "compare" and args.parent is None:
        print("temporal_parts: --section compare needs --parent DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("temporal_parts: needs a CUDA card (the kernels have no CPU mode)",
              file=sys.stderr)
        return 2
    card = _nvidia_smi()
    print(card)
    res = {"card": card}
    for name, fn in (("parts", parts), ("designs", designs), ("sweep", sweep)):
        if args.section in ("all", name):
            res[name] = fn(args.runs)
    if args.parent is not None and args.section in ("all", "compare"):
        res["compare"] = compare(args.runs, args.parent)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
