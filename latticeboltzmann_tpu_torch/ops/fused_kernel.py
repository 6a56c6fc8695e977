"""The fused stream-collide kernel's runner surface: twin of the
Session / run_steps surface of latticeboltzmann_tpu/ops/fused_kernel.py.

One launch of csrc/lbm_step.cu advances the whole lattice one step out
of place: forcing at column 0, periodic pull, BGK collision and
bounce-back, in the JAX package's fused-kernel arithmetic order. The
`step` wrapper launches it for CUDA tensors and takes `step_reference`,
its plain PyTorch version, for CPU tensors; anything else raises.

State is the unpadded (9, NX, NY) float32 layout: the TPU kernel's
mirror-pad lanes, VMEM staging and temporal blocking have no
counterpart here (ROADMAP, "Not to port").
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core.spec import NSPEEDS, OPPOSITE, W, LatticeConfig
from . import cuda_build, stream_collide

# kernel launches made by `step`, for callers that must show a run went
# through the kernel (chip_smoke.py resets and reads it)
LAUNCHES = 0

# solid planes whose codes were checked, by tensor, with the version
# counter at the check: the check syncs with the device, so it runs once
# per plane and again only after an in-place write to it
_CHECKED_SOLID = WeakIdKeyDictionary()


@functools.lru_cache(maxsize=64)
def kernel_constants(cfg: LatticeConfig) -> tuple[float, ...]:
    """The kernel's launch constants, rounded to float32 the way the JAX
    fused kernel rounds them (ops/fused_kernel.py:424-434 there, then
    the folded products at :1041-1053): (c1, iw0, iw14, iw58, k3, k6,
    half, a14, a58), the order of Params in csrc/lbm_step.cu. Cached:
    `step` reads them at every launch."""
    dt = np.float32
    one, three, half, sixth = dt(1.0), dt(3.0), dt(0.5), dt(1.0 / 6.0)
    csq, icsq, itau = dt(cfg.csq), dt(1.0 / cfg.csq), dt(1.0 / cfg.tau)
    w = [dt(W[s]) for s in range(NSPEEDS)]
    a14 = dt(cfg.accel) * dt(W[1])
    a58 = dt(cfg.accel) * dt(W[5])
    return tuple(
        float(x) for x in (one - itau, itau * w[0], itau * w[1], itau * w[5],
                           three * icsq, sixth * csq, half, a14, a58)
    )


def collide_reference(pulled: torch.Tensor, cfg: LatticeConfig) -> torch.Tensor:
    """BGK collision in the fused kernel's association order: moments
    from the d56/d78/d58/d67 partial sums, relaxation folded into the
    weights, the quadratic term shared by each opposite pair."""
    c1, iw0, iw14, iw58, k3, k6, half, _, _ = kernel_constants(cfg)
    p = pulled
    d56 = p[5] + p[6]
    d78 = p[7] + p[8]
    d58 = p[5] + p[8]
    d67 = p[6] + p[7]
    density = (p[0] + (p[1] + p[3])) + ((p[2] + p[4]) + (d56 + d78))
    inv_rho = torch.ones((), dtype=p.dtype, device=p.device) / density
    u_x = ((p[2] - p[4]) + (d56 - d78)) * inv_rho
    u_y = ((p[1] - p[3]) + (d58 - d67)) * inv_rho
    ux3 = k3 * u_x
    uy3 = k3 * u_y
    base = 1.0 - k6 * (ux3 * ux3 + uy3 * uy3)
    r0, r14, r58 = iw0 * density, iw14 * density, iw58 * density
    out = [None] * NSPEEDS
    out[0] = c1 * p[0] + r0 * base
    for sp, sn, r, eu in ((1, 3, r14, uy3), (2, 4, r14, ux3),
                          (5, 7, r58, ux3 + uy3), (6, 8, r58, ux3 - uy3)):
        q = base + half * eu * eu
        out[sp] = c1 * p[sp] + r * (q + eu)
        out[sn] = c1 * p[sn] + r * (q - eu)
    return torch.stack(out)


def step_reference(
    src: torch.Tensor, solid: torch.Tensor | None, cfg: LatticeConfig
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's one step: forcing, pull,
    collision in the fused order, bounce-back with wall-f0 passthrough.
    solid: (NX, NY) uint8 codes (0 fluid, 1 bounce-back), or None for
    the wall-free variant. Returns a new tensor."""
    walls = (
        torch.zeros(src.shape[1:], dtype=torch.bool, device=src.device)
        if solid is None else solid != 0
    )
    pulled = stream_collide.pull(stream_collide.apply_source(src, walls, cfg))
    out = collide_reference(pulled, cfg)
    if solid is None:
        return out
    return torch.where(walls[None], pulled[OPPOSITE.tolist()], out)


def check_solid(solid: torch.Tensor) -> None:
    """Raise unless every code is 0 (fluid) or 1 (bounce-back): the slip
    codes 2/3 of the JAX package's class_plane are ROADMAP B3. Syncs
    with the device, so `step` memoizes it per plane."""
    if _CHECKED_SOLID.get(solid) == solid._version:
        return
    if solid.numel() and int(solid.max()) > 1:
        raise ValueError(
            "solid codes other than 0 (fluid) and 1 (bounce-back) are not "
            "supported yet (slip codes 2/3 are ROADMAP B3)"
        )
    _CHECKED_SOLID[solid] = solid._version


def _require_float32(cfg: LatticeConfig) -> None:
    if np.dtype(cfg.dtype) != np.dtype(np.float32):
        raise NotImplementedError(
            f"the stream-collide kernel takes float32 state only; "
            f"{np.dtype(cfg.dtype)} is ROADMAP B3"
        )


def check_device(t: torch.Tensor) -> None:
    """Raise unless t lies on the CPU (where a wrapper takes the plain
    version) or on the current device of an available CUDA card."""
    if t.device.type == "cpu":
        return
    if t.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the kernel needs a CUDA tensor on an available card, got a tensor on {t.device}"
        )
    if t.get_device() != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {t.device}, current device cuda:{torch.cuda.current_device()}"
        )


def check_solid_plane(solid, shape: tuple, device: torch.device) -> None:
    """Raise unless solid is a contiguous uint8 (NX, NY) plane on
    `device` holding codes 0 and 1 only."""
    if solid is None:
        raise ValueError("the masked variant needs a solid plane")
    if solid.dtype != torch.uint8 or tuple(solid.shape) != shape:
        raise ValueError(f"solid must be uint8 {shape}, got {solid.dtype} {tuple(solid.shape)}")
    if not solid.is_contiguous() or solid.device != device:
        raise ValueError("solid must be contiguous and on src's device")
    check_solid(solid)


def _check(src, dst, solid, cfg: LatticeConfig, has_walls: bool) -> None:
    _require_float32(cfg)
    check_device(src)
    shape = (NSPEEDS, cfg.nx, cfg.ny)
    if src is dst or src.data_ptr() == dst.data_ptr():
        raise ValueError("step is out of place: src and dst must be distinct buffers")
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} (other dtypes: ROADMAP B3)")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dst.device != src.device:
        raise ValueError(f"dst on {dst.device}, src on {src.device}")
    if has_walls:
        check_solid_plane(solid, shape[1:], src.device)


def step(
    src: torch.Tensor,
    dst: torch.Tensor,
    solid: torch.Tensor | None,
    cfg: LatticeConfig,
    *,
    has_walls: bool,
) -> torch.Tensor:
    """One step src -> dst; returns dst. On a CUDA tensor it launches the
    kernel (the masked variant when has_walls, else the wall-free one)
    on the current stream and counts it in LAUNCHES; on a CPU tensor it
    writes step_reference's result. Raises on anything the kernel does
    not take, and on any other device."""
    global LAUNCHES
    _check(src, dst, solid, cfg, has_walls)
    if src.device.type == "cpu":
        dst.copy_(step_reference(src, solid if has_walls else None, cfg))
        return dst
    params = (ctypes.c_float * 9)(*kernel_constants(cfg))
    rc = cuda_build.load_library().lbm_stream_collide_f32_launch(
        src.data_ptr(), dst.data_ptr(), solid.data_ptr() if has_walls else None,
        cfg.nx, cfg.ny, int(has_walls), ctypes.addressof(params),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lbm_stream_collide_f32 launch failed: cudaError {rc}")
    LAUNCHES += 1
    return dst


class Session:
    """Persistent state for one lattice configuration on one device: the
    solid plane and two preallocated (9, NX, NY) buffers that swap roles
    every step (the analog of the JAX kernel's aliased donor buffer).
    The masked variant runs when the mask has a solid site, the
    wall-free variant otherwise.

    Usage:
        sess = Session(cfg, walls, device="cuda")
        sess.load(f)       # copy the state in
        sess.advance(n)    # n launches, no host sync
        sess.block()       # completion barrier
        f = sess.state()   # a copy; the session keeps running
    """

    def __init__(self, cfg: LatticeConfig, walls, *, device: str | torch.device):
        _require_float32(cfg)
        walls_np = np.asarray(walls, dtype=bool)
        if walls_np.shape != (cfg.nx, cfg.ny):
            raise ValueError(f"walls shape {walls_np.shape} != {(cfg.nx, cfg.ny)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.has_walls = bool(walls_np.any())
        self.solid = torch.as_tensor(walls_np.astype(np.uint8), device=self.device)
        self._a = self._b = None

    def load(self, f: torch.Tensor) -> None:
        """Copy (9, NX, NY) state into the session's buffers (allocated
        at the first load)."""
        if self._a is None:
            shape = (NSPEEDS, self.cfg.nx, self.cfg.ny)
            self._a = torch.empty(shape, dtype=torch.float32, device=self.device)
            self._b = torch.empty_like(self._a)
        self._a.copy_(f)

    def advance(self, n_steps: int) -> None:
        """n_steps launches, swapping the two buffers after each."""
        a, b = self._a, self._b
        for _ in range(n_steps):
            step(a, b, self.solid, self.cfg, has_walls=self.has_walls)
            a, b = b, a
        self._a, self._b = a, b

    def block(self) -> None:
        """Completion barrier for the launches so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def state(self) -> torch.Tensor:
        """The current state, copied (the session keeps its buffers)."""
        return self._a.clone()

    def unload(self) -> torch.Tensor:
        """The current state; the session releases its buffers."""
        out, self._a, self._b = self._a, None, None
        return out


def run_steps(f: torch.Tensor, walls, cfg: LatticeConfig, n_steps: int) -> torch.Tensor:
    """Unpadded in, unpadded out: the one-shot form of Session on f's
    device. `f` is not modified."""
    sess = Session(cfg, walls.cpu().numpy() if torch.is_tensor(walls) else walls,
                   device=f.device)
    sess.load(f)
    sess.advance(n_steps)
    return sess.unload()
