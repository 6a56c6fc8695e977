"""The fused double-single (f32-pair) kernel's runner surface, backend
'cuda-ds64': twin of the local form of
latticeboltzmann_tpu/ops/fused_ds_kernel.py (`_make_ds_pass`, `run_steps`).

One launch of csrc/lbm_ds_step.cu advances the whole pair state one step
out of place: forcing at column 0 at pair precision, periodic pull, BGK
collision at pair precision and masked bounce-back. `exact` selects the
collision: ds_engine.collide_planes (the exact tier, bitwise the
'torch-ds64' arithmetic) or ds_engine.collide_planes_fast (the fast tier,
the default, as on 'pallas-ds64'). The `step` wrapper launches the kernel
for CUDA tensors and takes `step_reference`, its plain PyTorch version,
for CPU tensors; anything else raises.

State is the unpadded DS pair of (9, NX, NY) float32 planes. The TPU
kernel's mirror-pad lanes, pad re-mirroring, row blocks, halo rows and
temporal blocking have no counterpart here (ROADMAP, "Not to port").
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.spec import NSPEEDS, LatticeConfig
from . import cuda_build, df64, ds_engine
from .df64 import DS
from .fused_kernel import check_device, check_solid_plane

# kernel launches made by `step`, for callers that must show a run went
# through the kernel (chip_smoke.py resets and reads it)
LAUNCHES = 0

# the JAX kernel's default temporal-blocking depth; its results are
# bitwise independent of it, and here it has no effect at all
DS_TEMPORAL = 4

# device-memory bytes per site update: two f32 components, 9 reads and
# 9 writes each (the 1 B mask read of the masked variant not counted)
BYTES_PER_SITE_DS = 2 * 2 * NSPEEDS * 4


@functools.lru_cache(maxsize=64)
def kernel_constants_ds(cfg: LatticeConfig, exact: bool) -> tuple[float, ...]:
    """The host floats the kernel takes, split on the host from float64
    exactly as ds_engine splits them, in the order of Params in
    csrc/lbm_ds_step.cu.

    exact=False (the fast tier, 30 floats): the split_const quads
    (hi, lo, hh, hl) of c1, iw0, iw14, iw58, c3, csixth, then the pairs
    one, a14, a58. exact=True (20 floats): the pairs one, itau, c3, c45,
    c15, w0, w14, w58, a14, a58. Cached: `step` reads them at every
    launch."""
    if exact:
        vals = [x for v in ds_engine._const_values(cfg).values()
                for x in df64.const_literal(v)]
    else:
        vals = [x for v in ds_engine._fast_const_values(cfg).values() for x in v]
    return tuple(float(x) for x in vals)


def step_reference(
    hi: torch.Tensor, lo: torch.Tensor, solid: torch.Tensor | None,
    cfg: LatticeConfig, exact: bool,
) -> DS:
    """Plain PyTorch version of the kernel's one step: pair forcing,
    pull, the exact or fast collision, bounce-back with wall-f0
    passthrough. solid: (NX, NY) uint8 codes (0 fluid, 1 bounce-back),
    or None for the wall-free variant. Returns a new pair."""
    dev = hi.device
    walls = (
        torch.zeros(hi.shape[1:], dtype=torch.bool, device=dev)
        if solid is None else solid != 0
    )
    C = ds_engine._consts(cfg, dev) if exact else ds_engine._consts_fast(cfg, dev)
    collide = ds_engine.collide_planes if exact else ds_engine.collide_planes_fast
    pulled = ds_engine.pull(ds_engine.apply_source(DS(hi, lo), walls, cfg, C))
    planes = [DS(pulled.hi[s], pulled.lo[s]) for s in range(NSPEEDS)]
    return ds_engine.bounce_back(pulled, collide(planes, C), walls)


def _require_float64(cfg: LatticeConfig) -> None:
    if np.dtype(cfg.dtype) != np.dtype(np.float64):
        raise ValueError(
            "the ds kernel carries DP-class state; construct the LatticeConfig "
            "with dtype=np.float64 (the host-side precision of the pair)"
        )


def _check(src: DS, dst: DS, solid, cfg: LatticeConfig, has_walls: bool) -> None:
    """The checks of fused_kernel.step, for both pair components."""
    _require_float64(cfg)
    dev = src.hi.device
    check_device(src.hi)
    shape = (NSPEEDS, cfg.nx, cfg.ny)
    named = (("src.hi", src.hi), ("src.lo", src.lo), ("dst.hi", dst.hi), ("dst.lo", dst.lo))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, src.hi on {dev}")
    # out of place, four distinct buffers: the pull never reads what the
    # step writes, and hi and lo never share storage
    ptrs = [t.untyped_storage().data_ptr() for _, t in named]
    if len(set(ptrs)) != 4:
        raise ValueError("step is out of place: src.hi, src.lo, dst.hi and dst.lo "
                         "must be four distinct buffers")
    if has_walls:
        check_solid_plane(solid, shape[1:], dev)


def step(
    src: DS,
    dst: DS,
    solid: torch.Tensor | None,
    cfg: LatticeConfig,
    *,
    has_walls: bool,
    exact: bool = False,
) -> DS:
    """One step src -> dst; returns dst. On CUDA tensors it launches the
    kernel (masked variant when has_walls, fast tier unless exact) on the
    current stream and counts it in LAUNCHES; on CPU tensors it writes
    step_reference's result. Raises on anything the kernel does not
    take, and on any other device."""
    global LAUNCHES
    _check(src, dst, solid, cfg, has_walls)
    if src.hi.device.type == "cpu":
        out = step_reference(src.hi, src.lo, solid if has_walls else None, cfg, exact)
        dst.hi.copy_(out.hi)
        dst.lo.copy_(out.lo)
        return dst
    consts = kernel_constants_ds(cfg, exact)
    params = (ctypes.c_float * len(consts))(*consts)
    rc = cuda_build.load_library().lbm_stream_collide_ds_launch(
        src.hi.data_ptr(), src.lo.data_ptr(), dst.hi.data_ptr(), dst.lo.data_ptr(),
        solid.data_ptr() if has_walls else None,
        cfg.nx, cfg.ny, int(has_walls), int(exact), ctypes.addressof(params),
        torch.cuda.current_stream(src.hi.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lbm_stream_collide_ds launch failed: cudaError {rc}")
    LAUNCHES += 1
    return dst


class Session:
    """Persistent pair state for one lattice configuration on one
    device: the solid plane and four preallocated (9, NX, NY) float32
    buffers (hi and lo, in and out) that swap roles every step. The
    masked variant runs when the mask has a solid site, the wall-free
    variant otherwise; `exact` selects the tier.

    Usage:
        sess = Session(cfg, walls, device="cuda")
        sess.load(f)       # copy a DS pair in
        sess.advance(n)    # n launches, no host sync
        sess.block()       # completion barrier
        f = sess.state()   # a copy; the session keeps running
    """

    def __init__(self, cfg: LatticeConfig, walls, *, device: str | torch.device,
                 exact: bool = False):
        _require_float64(cfg)
        walls_np = np.asarray(walls, dtype=bool)
        if walls_np.shape != (cfg.nx, cfg.ny):
            raise ValueError(f"walls shape {walls_np.shape} != {(cfg.nx, cfg.ny)}")
        self.cfg = cfg
        self.exact = exact
        self.device = torch.device(device)
        self.has_walls = bool(walls_np.any())
        self.solid = torch.as_tensor(walls_np.astype(np.uint8), device=self.device)
        self._a = self._b = None

    def load(self, f: DS) -> None:
        """Copy a DS pair into the session's buffers (allocated at the
        first load)."""
        if self._a is None:
            shape = (NSPEEDS, self.cfg.nx, self.cfg.ny)

            def buf():
                return torch.empty(shape, dtype=torch.float32, device=self.device)

            self._a, self._b = DS(buf(), buf()), DS(buf(), buf())
        self._a.hi.copy_(f.hi)
        self._a.lo.copy_(f.lo)

    def advance(self, n_steps: int) -> None:
        """n_steps launches, swapping the two pairs after each."""
        a, b = self._a, self._b
        for _ in range(n_steps):
            step(a, b, self.solid, self.cfg, has_walls=self.has_walls, exact=self.exact)
            a, b = b, a
        self._a, self._b = a, b

    def block(self) -> None:
        """Completion barrier for the launches so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def state(self) -> DS:
        """The current pair, copied (the session keeps its buffers)."""
        return DS(self._a.hi.clone(), self._a.lo.clone())

    def unload(self) -> DS:
        """The current pair; the session releases its buffers."""
        out, self._a, self._b = self._a, None, None
        return out


def run_steps(f: DS, walls, cfg: LatticeConfig, n_steps: int, exact: bool = False,
              temporal: int = DS_TEMPORAL) -> DS:
    """n_steps of the kernel on f's device, unpadded in and out; `f` is
    not modified. `temporal` is accepted for the JAX signature: it sets
    the TPU kernel's fusion depth only (its results are bitwise
    independent of it) and this kernel runs one step per launch."""
    del temporal
    sess = Session(cfg, walls.cpu().numpy() if torch.is_tensor(walls) else walls,
                   device=f.hi.device, exact=exact)
    sess.load(f)
    sess.advance(n_steps)
    return sess.unload()
