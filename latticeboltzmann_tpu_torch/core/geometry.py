"""Wall-geometry builders.

Walls are a boolean (NX, NY) mask; True = solid (bounce-back) site.
The default scene reproduces the reference's InitializeArrays geometry
(src/latticeboltzmann.c:567-578): solid top/bottom rows plus a 200x5
barrier block, giving the channel-with-plate wake scene of img/flow.gif.

A copy of latticeboltzmann_tpu/core/geometry.py (numpy-only; importing
it through its package loads jax). tests/test_torch_core.py pins every
builder, spec_mask and infer_spec equal to the original.
"""

from __future__ import annotations

import numpy as np


def empty(nx: int, ny: int) -> np.ndarray:
    """Fully periodic fluid box, no walls."""
    return np.zeros((nx, ny), dtype=bool)


def channel(nx: int, ny: int) -> np.ndarray:
    """Channel: solid rows at i=0 and i=NX-1 (src/latticeboltzmann.c:575-578)."""
    walls = empty(nx, ny)
    walls[0, :] = True
    walls[nx - 1, :] = True
    return walls


def channel_with_barrier(
    nx: int,
    ny: int,
    *,
    barrier_rows: tuple[int, int] | None = None,
    barrier_cols: tuple[int, int] | None = None,
) -> np.ndarray:
    """The reference's default scene (src/latticeboltzmann.c:567-578):
    channel walls plus a flat plate at rows [20, 220) x cols [100, 105),
    scaled proportionally for other lattice sizes.
    """
    walls = channel(nx, ny)
    if barrier_rows is None:
        barrier_rows = (round(nx * 20 / 400), round(nx * 220 / 400))
    if barrier_cols is None:
        barrier_cols = (round(ny * 100 / 2000), round(ny * 105 / 2000))
    r0, r1 = barrier_rows
    c0, c1 = barrier_cols
    walls[r0:r1, c0:c1] = True
    return walls


def reference_barrier(nx: int = 400, ny: int = 2000) -> np.ndarray:
    """Exact reference geometry: barrier at rows [20,220) x cols [100,105),
    independent of lattice size (src/latticeboltzmann.c:567-573). Requires
    nx >= 220, ny >= 105."""
    return channel_with_barrier(nx, ny, barrier_rows=(20, 220), barrier_cols=(100, 105))


def channel_with_cylinder(
    nx: int,
    ny: int,
    *,
    center: tuple[float, float] | None = None,
    radius: float | None = None,
) -> np.ndarray:
    """Channel with a circular obstacle — the 'cylinder wake' benchmark scene
    (BASELINE.json config 3). Defaults: center at (NX/2, NY/8), radius NX/9.
    """
    walls = channel(nx, ny)
    if center is None:
        center = (nx / 2.0, ny / 8.0)
    if radius is None:
        radius = nx / 9.0
    ci, cj = center
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    walls |= (ii - ci) ** 2 + (jj - cj) ** 2 <= radius**2
    return walls


# --- parametric wall specs -------------------------------------------------
#
# A wall spec is a hashable tuple of primitives describing the mask in
# closed form: (("channel",), ("rect", r0, r1, c0, c1), ("circle2", ci2,
# cj2, r2q)). The JAX package's fused Pallas kernel specializes on the spec and
# computes the mask from iotas in VMEM, eliminating the walls-plane HBM
# DMA entirely — the TPU analog of the reference hard-coding its geometry
# at compile time (src/latticeboltzmann.c:567-578). "circle2" stores the
# doubled center (so half-integer centers stay exact) and the quadrupled
# squared radius; membership is the exact int32 test
# (2i-ci2)^2 + (2j-cj2)^2 <= r2q.


def spec_mask(spec, nx: int, ny: int) -> np.ndarray:
    """Materialize a wall spec as an (nx, ny) bool mask, using the same
    integer arithmetic the kernel uses (so equality checks are exact)."""
    ii, jj = np.meshgrid(
        np.arange(nx, dtype=np.int64), np.arange(ny, dtype=np.int64), indexing="ij"
    )
    m = np.zeros((nx, ny), dtype=bool)
    for prim in spec:
        kind = prim[0]
        if kind == "channel":
            m |= (ii == 0) | (ii == nx - 1)
        elif kind == "rect":
            _, r0, r1, c0, c1 = prim
            m |= (ii >= r0) & (ii < r1) & (jj >= c0) & (jj < c1)
        elif kind == "circle2":
            _, ci2, cj2, r2q = prim
            m |= (2 * ii - ci2) ** 2 + (2 * jj - cj2) ** 2 <= r2q
        else:
            raise ValueError(f"unknown wall-spec primitive {kind!r}")
    return m


def infer_spec(walls: np.ndarray):
    """Recover a parametric spec from a wall mask, or None if the mask
    is not one of the closed forms. The candidate spec is verified by
    exact mask equality, so a non-None result always reproduces `walls`
    bit-for-bit."""
    walls = np.asarray(walls, dtype=bool)
    nx, ny = walls.shape
    spec = []
    interior = walls.copy()
    if walls[0].all() and walls[nx - 1].all():
        spec.append(("channel",))
        interior[0] = False
        interior[nx - 1] = False
    si, sj = np.nonzero(interior)
    if si.size:
        r0, r1 = int(si.min()), int(si.max()) + 1
        c0, c1 = int(sj.min()), int(sj.max()) + 1
        if interior[r0:r1, c0:c1].all():
            spec.append(("rect", r0, r1, c0, c1))
        else:
            # try an exact integer circle around the doubled centroid.
            # The kernel evaluates (2i-ci2)^2 + (2j-cj2)^2 in int32 with
            # i up to nx-1 and j up to the padded lane count (< ny+128);
            # refuse the spec (DMA-mask fallback) when that sum could
            # overflow int32 and silently corrupt the mask.
            m = max(nx, ny + 128)
            if 8 * m * m >= 2**31:
                return None
            ci2 = int(np.round(2 * si.mean()))
            cj2 = int(np.round(2 * sj.mean()))
            r2q = int(((2 * si - ci2) ** 2 + (2 * sj - cj2) ** 2).max())
            spec.append(("circle2", ci2, cj2, r2q))
    spec = tuple(spec)
    if spec_mask(spec, nx, ny).tobytes() == walls.tobytes():
        return spec
    return None


BUILDERS = {
    "empty": empty,
    "channel": channel,
    "barrier": channel_with_barrier,
    "reference": reference_barrier,
    "cylinder": channel_with_cylinder,
}


def build(name: str, nx: int, ny: int, **kwargs) -> np.ndarray:
    try:
        fn = BUILDERS[name]
    except KeyError:
        raise ValueError(f"unknown geometry {name!r}; options: {sorted(BUILDERS)}")
    return fn(nx, ny, **kwargs)
