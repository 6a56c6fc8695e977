"""The CLI's backend and device choice, and the pair-DP path through the
CLI. Two faults of the port against the JAX package are pinned here:

- `--precision f64` with `--backend auto` on a card resolved to the
  float32-only kernel backend and raised; the JAX CLI resolves auto to
  its plain engine's route for float64 (latticeboltzmann_tpu/cli.py:90-99
  and the planner's float64 route), so the port now picks "torch".
- the "torch" backends ran on the CPU even with a card present; JAX's
  "xla" runs on its default device, the accelerator.

The card is monkeypatched: no CUDA tensor is allocated.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, available_backends, geometry
from latticeboltzmann_tpu_torch.cli import build_parser, resolve_backend
from latticeboltzmann_tpu_torch.models.engine import default_device

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("card", [True, False])
def test_auto_backend_follows_precision_and_card(card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    assert resolve_backend("auto", np.float32) == ("cuda" if card else "torch")
    assert resolve_backend("auto", np.float64) == "torch"
    # an explicit choice is never rerouted: cuda with f64 still raises in
    # Simulation (the kernel takes float32 only)
    assert resolve_backend("cuda", np.float64) == "cuda"
    assert resolve_backend("cuda-ds64", np.float64) == "cuda-ds64"


@pytest.mark.parametrize("card", [True, False])
def test_default_device_follows_the_card(card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    for backend in ("torch", "torch-ds64"):
        assert default_device(backend) == ("cuda" if card else "cpu")
    for backend in ("cuda", "cuda-ds64"):
        assert default_device(backend) == "cuda"


def test_explicit_device_wins(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    for backend in ("torch", "torch-ds64"):
        sim = Simulation(cfg, geometry.empty(16, 40), backend=backend, device="cpu")
        assert sim.device.type == "cpu"


def test_cli_ds64_end_to_end():
    proc = subprocess.run(
        [sys.executable, "-m", "latticeboltzmann_tpu_torch", "--nx", "16", "--ny", "40",
         "--steps", "20", "--backend", "torch-ds64", "--precision", "f64",
         "--print-stats-every", "10", "--warmup", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("Lattice Size: 16x40")
    assert "backend=torch-ds64 precision=f64 device=cpu" in lines[0]
    re_printed = float(lines[-2].split(" Re ")[1])
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    sim = Simulation(cfg, geometry.build("barrier", 16, 40), backend="torch-ds64").run(20)
    assert re_printed == pytest.approx(sim.reynolds(), rel=1e-9)


def test_cli_backend_help_covers_registry():
    """The --backend help names every registered backend, as
    tests/test_core.py:95-105 pins for the JAX CLI."""
    helptext = next(a.help for a in build_parser()._actions
                    if "--backend" in getattr(a, "option_strings", ()))
    missing = [b for b in available_backends() if b not in helptext]
    assert not missing, f"--backend help omits {missing}"
    assert "sharded-cuda-rdma" in available_backends()


@pytest.mark.parametrize("argv,want", [([], None), (["--skew"], True), (["--no-skew"], False)])
def test_cli_skew_flags_parse(argv, want):
    """--skew / --no-skew as the JAX CLI (latticeboltzmann_tpu/cli.py:73-79):
    None unless given."""
    assert build_parser().parse_args(argv).skew is want


def test_cli_skew_runs_and_changes_nothing():
    outs = []
    for flag in ("--skew", "--no-skew"):
        proc = subprocess.run(
            [sys.executable, "-m", "latticeboltzmann_tpu_torch", "--nx", "16", "--ny", "40",
             "--steps", "60", "--backend", "torch", "--print-stats-every", "0", "--warmup", "0",
             flag],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        outs.append([line.split(" Re ")[1] for line in proc.stdout.splitlines() if " Re " in line])
    assert len(outs[0]) == 1 and outs[0] == outs[1]


def test_cli_opts_in_to_an_experimental_backend_named_outright(monkeypatch):
    """`--backend sharded-cuda-rdma` on the command line is the opt-in; it
    then asks for its card like every kernel backend, and `auto` never
    resolves to it."""
    from latticeboltzmann_tpu_torch import cli

    seen = {}

    class Recorder:
        def __init__(self, cfg, walls, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr("latticeboltzmann_tpu_torch.models.engine.Simulation", Recorder)
    for backend, opted in (("sharded-cuda-rdma", True), ("auto", False)):
        with pytest.raises(SystemExit):
            cli.main(["--nx", "16", "--ny", "40", "--backend", backend])
        assert seen["allow_experimental"] is opted and seen["skew"] is None
        assert seen["backend"] == (backend if opted else resolve_backend("auto", np.float32))


# --- the JAX CLI's flags and run loop (snapshots, checkpoints, probes, the
# movie, profiling, --resume, --debug-nans) ---------------------------------

from latticeboltzmann_tpu import cli as jax_cli  # noqa: E402
from latticeboltzmann_tpu_torch import cli as port_cli  # noqa: E402
from latticeboltzmann_tpu_torch.models import engine  # noqa: E402
from latticeboltzmann_tpu_torch.parallel import sharded  # noqa: E402
from latticeboltzmann_tpu_torch.utils import checkpoint, viz  # noqa: E402

torch.set_num_threads(1)

# the pair-DP bar against the unbroken run: a float64 checkpoint of a ds
# pair is split again at load time, which may move the last bits of lo
# (tests/test_ds.py:213-229's bar)
DS_RTOL = 1e-11

_JAX_OPTIONS = {s: a for a in jax_cli.build_parser()._actions for s in a.option_strings}
_PORT_OPTIONS = {s: a for a in build_parser()._actions for s in a.option_strings}


@pytest.mark.parametrize("option", sorted(_JAX_OPTIONS))
def test_cli_parser_has_every_jax_option(option):
    """Every option string of the JAX CLI parses on the port's, with the
    same default, choices, type and destination (tests/test_core.py:79-93
    pins the reference's knobs on the JAX side). The help texts are the
    documented difference: they name the port's backends, torch.profiler,
    and where --debug-nans checks."""
    assert option in _PORT_OPTIONS, option
    j, t = _JAX_OPTIONS[option], _PORT_OPTIONS[option]
    for attr in ("dest", "default", "choices", "type", "nargs", "const", "required"):
        assert getattr(t, attr) == getattr(j, attr), (option, attr)
    assert type(t) is type(j)


def test_cli_parser_extras_as_jax():
    """tests/test_core.py:108-115 on the port's parser."""
    args = build_parser().parse_args(
        ["--geometry", "cylinder", "--backend", "cuda", "--resume", "latest",
         "--movie", "out.gif", "--debug-nans", "--probe", "3,5", "--probe", "7,9"])
    assert args.geometry == "cylinder" and args.debug_nans and args.resume == "latest"
    assert args.probe == ["3,5", "7,9"] and args.movie == "out.gif"


def _walls(name, nx, ny):
    from latticeboltzmann_tpu_torch.core import geometry as port_geometry

    return port_geometry.build(name, nx, ny)


def _argv(tmp, backend, precision, nx, steps=20, **extra):
    """tests/test_utils.py:163-178's command line, its paths under tmp."""
    argv = ["--nx", str(nx), "--ny", "40", "--steps", str(steps),
            "--backend", backend, "--precision", precision,
            "--print-stats-every", "10",
            "--save-lattice-every", "10", "--snapshot-dir", str(tmp / "data"),
            "--checkpoint-every", "20", "--checkpoint-dir", str(tmp / "ck"),
            "--probe", "3,5", "--probe-every", "10", "--probe-out", str(tmp / "probes.csv"),
            "--warmup", "2"]
    for k, v in extra.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return argv


def _run(argv, capsys):
    """port_cli.main in this process: (exit code, stdout, stderr)."""
    rc = port_cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _cpu_sharded(monkeypatch, shards):
    """backend "sharded" over a CPU mesh of `shards` (the default mesh is
    every visible card, or the one CPU)."""
    mesh = sharded.make_mesh(devices=["cpu"] * shards)
    monkeypatch.setitem(engine._BACKENDS, "sharded", sharded.make_backend(mesh))


_CFG_DTYPES = {"f32": np.float32, "f64": np.float64, "bf16": "bfloat16"}


@pytest.mark.parametrize(
    "backend,precision,nx",
    [("torch", "f32", 24), ("torch", "bf16", 24), ("torch-ds64", "f64", 24),
     ("sharded", "f32", 64)],  # 8 rows a shard on an 8-shard CPU mesh
)
def test_cli_end_to_end_and_resume(tmp_path, capsys, monkeypatch, backend, precision, nx):
    """tests/test_utils.py:147-199 on every backend class of the port, in
    process: stats lines, snapshots, probes, movie, checkpoint, profiler
    trace, final Re, with --debug-nans on; each snapshot byte-equal to
    Simulation.speed_squared() of a run of the same backend; then
    --resume latest for 20 more steps against an unbroken 40-step run:
    bitwise, and on the ds pair within DS_RTOL where the split at load
    moves lo's last bits."""
    if backend == "sharded":
        _cpu_sharded(monkeypatch, 8)
    argv = _argv(tmp_path, backend, precision, nx, movie=tmp_path / "flow.gif",
                 profile_dir=tmp_path / "prof", debug_nans=True)
    rc, out, err = _run(argv, capsys)
    assert rc == 0, err
    assert f"backend={backend} precision={precision} device=cpu" in out.splitlines()[0]
    assert "Runtime:" in out and " Re " in out
    cfg = LatticeConfig(nx=nx, ny=40, dtype=_CFG_DTYPES[precision])
    walls = _walls("barrier", nx, 40)
    sim = Simulation(cfg, walls, backend=backend)
    for step in (10, 20):
        usq = sim.run(10).speed_squared()
        grid = np.loadtxt(tmp_path / "data" / f"{step}.csv", delimiter=",")
        assert grid.shape == (nx, 40) and np.isfinite(grid).all()
        viz.write_snapshot_csv(tmp_path / "want.csv", usq)
        assert (tmp_path / "data" / f"{step}.csv").read_bytes() == \
            (tmp_path / "want.csv").read_bytes(), step
    probe_lines = (tmp_path / "probes.csv").read_text().splitlines()
    assert probe_lines[0] == "step,i,j,rho,u_x,u_y" and len(probe_lines) == 3
    assert all(np.isfinite([float(v) for v in ln.split(",")[3:]]).all()
               for ln in probe_lines[1:])
    assert (tmp_path / "flow.gif").stat().st_size > 0
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    spans = [e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]]
    # the warmup, then one chunk to each of steps 10 and 20
    assert spans.count("lbm_warmup") == 1 and spans.count("lbm_run") == 2
    step, f20, _, cfg20 = checkpoint.load(tmp_path / "ck" / "20.lbmckpt")
    assert step == 20 and cfg20 == cfg
    np.testing.assert_array_equal(f20, sim.state())

    # resume: the checkpoint's config wins over --precision
    other = "f32" if precision != "f32" else "bf16"
    rc, out, err = _run(["--resume", "latest", "--checkpoint-dir", str(tmp_path / "ck"),
                         "--checkpoint-every", "20", "--steps", "20", "--backend", backend,
                         "--precision", other, "--print-stats-every", "0", "--warmup", "2"],
                        capsys)
    assert rc == 0, err
    lines = out.splitlines()
    assert lines[0].startswith(f"resumed from {tmp_path / 'ck' / '20.lbmckpt'} at step 20")
    assert f"precision={precision} " in lines[1]
    _, f40, _, _ = checkpoint.load(tmp_path / "ck" / "40.lbmckpt")
    want = sim.run(20).state()
    if backend == "torch-ds64":
        # bitwise at this size and step (measured); the bar is DS_RTOL
        np.testing.assert_allclose(f40, want, rtol=DS_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(f40, want)
    if backend == "sharded":
        single = Simulation(cfg, walls, backend="torch").run(40).state()
        np.testing.assert_array_equal(f40, single)


def test_cli_f64_outputs_bitwise_jax_cli(tmp_path, capsys):
    """The same command line on the port's torch f64 and the JAX CLI's xla
    f64: snapshots, probe series and checkpoint byte for byte (float64
    eager PyTorch and the xla engine are both bitwise equal to golden,
    tests/test_torch_engine.py; the moments are the same binary ops)."""
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    argv = lambda d: _argv(d, "torch", "f64", 24, steps=20)  # noqa: E731
    assert port_cli.main(argv(port)) == 0
    assert jax_cli.main([a if a != "torch" else "xla" for a in argv(jax_dir)]) == 0
    capsys.readouterr()
    for rel in ("data/10.csv", "data/20.csv", "probes.csv", "ck/20.lbmckpt/f.raw",
                "ck/20.lbmckpt/walls.raw"):
        assert (port / rel).read_bytes() == (jax_dir / rel).read_bytes(), rel
    assert json.loads((port / "ck/20.lbmckpt/meta.json").read_text()) == \
        json.loads((jax_dir / "ck/20.lbmckpt/meta.json").read_text())


def test_cli_misaligned_event_intervals(tmp_path, capsys):
    """Events fire at multiples of their own interval (tests/test_utils.py:
    202-227), also after a resume from an unaligned step."""
    base = ["--nx", "24", "--ny", "40", "--backend", "torch", "--warmup", "0",
            "--snapshot-dir", str(tmp_path / "data"), "--checkpoint-dir", str(tmp_path / "ck")]
    rc, _, err = _run(base + ["--steps", "21", "--print-stats-every", "3",
                              "--save-lattice-every", "7", "--checkpoint-every", "10"], capsys)
    assert rc == 0, err
    assert sorted(p.name for p in (tmp_path / "data").iterdir()) == ["14.csv", "21.csv", "7.csv"]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["10.lbmckpt", "20.lbmckpt"]
    rc, _, err = _run(base + ["--resume", str(tmp_path / "ck" / "10.lbmckpt"), "--steps", "19",
                              "--print-stats-every", "0", "--save-lattice-every", "8",
                              "--checkpoint-every", "0"], capsys)
    assert rc == 0, err
    assert sorted(p.name for p in (tmp_path / "data").iterdir()) == \
        ["14.csv", "16.csv", "21.csv", "24.csv", "7.csv"]


@pytest.mark.parametrize("backend,precision,dtype", [("torch", "f32", np.float32),
                                                      ("torch-ds64", "f64", np.float64)])
def test_cli_debug_nans_stops_a_planted_nan(tmp_path, capsys, backend, precision, dtype):
    """A NaN planted in one site of a checkpoint's f.raw: resumed with
    --debug-nans the CLI exits 1 after its first chunk, naming the step,
    before that chunk's events; without the flag it runs to its end."""
    ck = tmp_path / "ck"
    rc, _, err = _run(["--nx", "24", "--ny", "40", "--steps", "10", "--backend", backend,
                       "--precision", precision, "--print-stats-every", "0", "--warmup", "0",
                       "--checkpoint-every", "10", "--checkpoint-dir", str(ck)], capsys)
    assert rc == 0, err
    raw = ck / "10.lbmckpt" / "f.raw"
    f = np.fromfile(raw, dtype=dtype)
    f[5 * 24 * 40 + 7 * 40 + 11] = np.nan
    f.tofile(raw)
    resume = ["--resume", "latest", "--checkpoint-dir", str(ck), "--backend", backend,
              "--steps", "10", "--print-stats-every", "5", "--checkpoint-every", "5",
              "--warmup", "2"]
    rc, out, err = _run(resume + ["--debug-nans"], capsys)
    assert rc == 1
    assert "NaN or inf after step 15" in err
    assert "Runtime:" not in out and not (ck / "15.lbmckpt").exists()
    rc, out, err = _run(resume, capsys)
    assert rc == 0, err
    assert (ck / "20.lbmckpt").exists()


def _no_simulation(monkeypatch):
    class Refused:
        def __init__(self, *a, **kw):
            raise AssertionError("a Simulation was built")

    monkeypatch.setattr("latticeboltzmann_tpu_torch.models.engine.Simulation", Refused)


@pytest.mark.parametrize("case", ["orbax", "movie", "orbax-resume", "no-checkpoint"])
def test_cli_refuses_before_any_step(tmp_path, capsys, monkeypatch, case):
    """--checkpoint-format orbax, --movie where matplotlib does not import,
    --resume of an orbax checkpoint and --resume latest of an empty
    directory exit 2 with a message, before a Simulation exists."""
    argv = ["--nx", "24", "--ny", "40", "--steps", "10", "--backend", "torch",
            "--snapshot-dir", str(tmp_path / "data"), "--checkpoint-dir", str(tmp_path / "ck")]
    if case == "orbax":
        argv += ["--checkpoint-format", "orbax", "--checkpoint-every", "5"]
        want = "orbax"
    elif case == "movie":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        argv += ["--movie", str(tmp_path / "flow.gif"), "--save-lattice-every", "5"]
        want = "matplotlib"
    elif case == "orbax-resume":
        (tmp_path / "ck" / "5.orbax").mkdir(parents=True)
        argv += ["--resume", "latest"]
        want = "ROADMAP A6"
    else:
        argv += ["--resume", "latest"]
        want = "no checkpoint found"
    _no_simulation(monkeypatch)
    rc, out, err = _run(argv, capsys)
    assert rc == 2 and want in err
    assert "Lattice Size" not in out and not (tmp_path / "data").exists()
