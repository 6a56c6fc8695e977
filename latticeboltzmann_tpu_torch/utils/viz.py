"""Field snapshots and flow-movie rendering: the port of
latticeboltzmann_tpu/utils/viz.py.

Reproduces the reference's offline visualization pipeline: PrintLattice
dumps per-site |u|^2 as CSV every SAVELATTICEEVERY steps
(src/latticeboltzmann.c:610-639), and plot.plt renders each CSV as a
log-color-scale matrix image then encodes a movie (plot.plt:1-18,
img/flow.gif). Here the field extraction runs on the state's own device
(only the (NX, NY) plane crosses to the host), snapshots write through
the native C++ writer when it builds (else NumPy, the same bytes), and
the movie renders with matplotlib, which is imported by the two render
functions only.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..ops.stream_collide import macroscopic
from .interop import to_numpy


def speed_squared(f: torch.Tensor) -> torch.Tensor:
    """|u|^2 of a (9, NX, NY) state on its own device, PrintLattice's
    math (src/latticeboltzmann.c:620-631) in the JAX function's
    association (stream_collide.macroscopic)."""
    _, u_x, u_y = macroscopic(f)
    return u_x * u_x + u_y * u_y


def write_snapshot_csv(path: str | pathlib.Path, usq: np.ndarray) -> None:
    """CSV layout matching the reference dump: one row per lattice row,
    '%.10lf' values, ', '-separated (src/latticeboltzmann.c:633-634),
    through utils/native.py (the C++ writer, or NumPy)."""
    from . import native

    native.write_csv(str(path), np.ascontiguousarray(usq, dtype=np.float64))


def save_snapshot_field(
    directory: str | pathlib.Path, timestep: int, usq: np.ndarray
) -> pathlib.Path:
    """data/<timestep>.csv from an already-extracted |u|^2 field: the
    entry point for every backend (the CLI goes Simulation.speed_squared()
    -> here, which serves the ds pair backends too)."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{timestep}.csv"
    write_snapshot_csv(path, np.asarray(usq))
    return path


def save_snapshot(
    directory: str | pathlib.Path, timestep: int, f: torch.Tensor
) -> pathlib.Path:
    """data/<timestep>.csv, the reference's naming
    (src/latticeboltzmann.c:612-613), from a (9, NX, NY) state."""
    return save_snapshot_field(directory, timestep, to_numpy(speed_squared(f)))


def render_frame(usq: np.ndarray, path: str | pathlib.Path, *, vmin=1e-7, vmax=None, dpi=80):
    """One frame: |u|^2 as a log-scale color image, the matplotlib
    equivalent of plot.plt's `set logscale cb; plot ... matrix with
    image` (plot.plt:7-14)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    usq = np.maximum(np.asarray(usq, dtype=np.float64), 1e-300)
    if vmax is None:
        vmax = max(float(usq.max()), vmin * 10)
    fig, ax = plt.subplots(figsize=(usq.shape[1] / dpi, usq.shape[0] / dpi), dpi=dpi)
    ax.imshow(usq, norm=LogNorm(vmin=vmin, vmax=vmax), cmap="inferno", origin="lower",
              aspect="auto", interpolation="nearest")
    ax.set_axis_off()
    fig.subplots_adjust(left=0, right=1, top=1, bottom=0)
    fig.savefig(path)
    plt.close(fig)


def render_movie(
    csv_dir: str | pathlib.Path,
    out_path: str | pathlib.Path = "flow.gif",
    *,
    vmin=1e-7,
    fps: int = 12,
) -> pathlib.Path:
    """Render all data/<n>.csv snapshots into an animated flow movie,
    the plot.plt + ffmpeg pipeline (plot.plt:11-17) in one call."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation
    from matplotlib.colors import LogNorm

    csv_dir = pathlib.Path(csv_dir)
    files = sorted(csv_dir.glob("*.csv"), key=lambda p: int(p.stem))
    if not files:
        raise FileNotFoundError(f"no snapshots in {csv_dir}")
    frames = [np.maximum(np.loadtxt(f, delimiter=","), 1e-300) for f in files]
    vmax = max(float(fr.max()) for fr in frames)
    fig, ax = plt.subplots(figsize=(8, 8 * frames[0].shape[0] / frames[0].shape[1]))
    im = ax.imshow(frames[0], norm=LogNorm(vmin=vmin, vmax=vmax), cmap="inferno",
                   origin="lower", aspect="auto", interpolation="nearest")
    ax.set_axis_off()
    fig.subplots_adjust(left=0, right=1, top=1, bottom=0)

    def update(k):
        im.set_data(frames[k])
        return (im,)

    anim = animation.FuncAnimation(fig, update, frames=len(frames), blit=True)
    out_path = pathlib.Path(out_path)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
