"""The port's copies of core/spec.py and core/geometry.py stay equal to
the JAX package's, and the port imports without jax."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu.core import geometry as jgeo
from latticeboltzmann_tpu.core import spec as jspec
from latticeboltzmann_tpu_torch.core import geometry as tgeo
from latticeboltzmann_tpu_torch.core import spec as tspec

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "name",
    ["E", "W", "OPPOSITE", "REFLECT_X", "REFLECT_Y", "POS_X", "NEG_X", "POS_Y",
     "NEG_Y", "NSPEEDS", "W0", "W14", "W58", "FLOP_PER_SITE"],
)
def test_spec_tables_equal(name):
    a, b = getattr(tspec, name), getattr(jspec, name)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"nx": 24, "ny": 40, "tau": 0.55, "csq": 0.9, "accel": 0.02,
          "initial_density": 0.3, "dtype": np.float64}],
)
def test_lattice_config_fields_and_properties(kwargs):
    t, j = tspec.LatticeConfig(**kwargs), jspec.LatticeConfig(**kwargs)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("itau", "viscosity", "sites"):
        assert getattr(t, prop) == getattr(j, prop)
    np.testing.assert_array_equal(t.equilibrium_rest(), j.equilibrium_rest())
    for dt in (np.float32, np.float64):
        assert tspec.bytes_per_site_update(dt) == jspec.bytes_per_site_update(dt)
    with pytest.raises(ValueError):
        tspec.LatticeConfig(nx=1, ny=4)
    with pytest.raises(NotImplementedError):
        tspec.LatticeConfig(wraparound=False)


@pytest.mark.parametrize("name", sorted(jgeo.BUILDERS))
def test_geometry_builders_equal(name):
    # reference_barrier needs nx >= 220 and ny >= 105
    shape = (240, 120) if name == "reference" else (24, 40)
    np.testing.assert_array_equal(
        tgeo.build(name, *shape), jgeo.build(name, *shape)
    )
    assert sorted(tgeo.BUILDERS) == sorted(jgeo.BUILDERS)


@pytest.mark.parametrize("name", ["channel", "barrier", "cylinder"])
def test_spec_mask_and_infer_spec_equal(name):
    walls = jgeo.build(name, 48, 96)
    spec = tgeo.infer_spec(walls)
    assert spec == jgeo.infer_spec(walls)
    assert spec is not None
    np.testing.assert_array_equal(tgeo.spec_mask(spec, 48, 96), jgeo.spec_mask(spec, 48, 96))
    np.testing.assert_array_equal(tgeo.spec_mask(spec, 48, 96), walls)


def test_build_rejects_unknown_geometry():
    with pytest.raises(ValueError, match="unknown geometry"):
        tgeo.build("no-such-scene", 8, 8)


def test_port_imports_without_jax():
    """Importing every module of the port, in a fresh interpreter,
    leaves jax out of sys.modules; no source line imports it."""
    code = (
        "import sys\n"
        "import latticeboltzmann_tpu_torch, latticeboltzmann_tpu_torch.bench, "
        "latticeboltzmann_tpu_torch.cli, latticeboltzmann_tpu_torch.utils.stats, "
        "latticeboltzmann_tpu_torch.ops.cuda_build, latticeboltzmann_tpu_torch.bench_suite, "
        "latticeboltzmann_tpu_torch.scripts.validate_ds, "
        "latticeboltzmann_tpu_torch.scripts.numerics_tiers, "
        "latticeboltzmann_tpu_torch.utils.native, latticeboltzmann_tpu_torch.utils.viz, "
        "latticeboltzmann_tpu_torch.utils.checkpoint, latticeboltzmann_tpu_torch.utils.profiler\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'latticeboltzmann_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'latticeboltzmann_tpu' not in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    imports_jax = re.compile(r"^\s*(import|from)\s+(jax|latticeboltzmann_tpu)\b")
    for path in (REPO / "latticeboltzmann_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not imports_jax.match(line), (path, line)
