"""A configuration's solid sites, made from its data: the walls the
benchmark hands to the program and to the reference alike, so neither
side's scene builder decides what both are held to.

A configuration's "walls" holds

    {"edges": true,                  # solid rows i = 0 and i = NX - 1
     "blocks": [[i0, i1, j0, j1]]}   # solid rows [i0, i1) x columns [j0, j1)

each key optional. The upstream's scene (jodavies/latticeboltzmann
src/latticeboltzmann.c:567-578) is the edges and the block
[20, 220) x [100, 105): a 200x5 plate across the channel.
"""

from __future__ import annotations

import numpy as np

KEYS = {"edges", "blocks"}


def walls(spec: dict, nx: int, ny: int) -> np.ndarray:
    """The (NX, NY) bool mask of solid sites that `spec` describes."""
    unknown = set(spec) - KEYS
    if unknown:
        raise ValueError(f"unknown walls keys {sorted(unknown)}")
    w = np.zeros((nx, ny), dtype=bool)
    if spec.get("edges"):
        w[0, :] = w[nx - 1, :] = True
    for i0, i1, j0, j1 in spec.get("blocks", []):
        if not (0 <= i0 < i1 <= nx and 0 <= j0 < j1 <= ny):
            raise ValueError(f"block {[i0, i1, j0, j1]} lies outside {nx}x{ny}")
        w[i0:i1, j0:j1] = True
    return w
