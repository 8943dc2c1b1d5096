"""ssdr_al_torch imports without jax, flax, optax, msgpack and
ssdr_al_tpu (data parallelism and the JAX snapshot reader included):
every submodule, in a fresh interpreter where `import jax` fails
(tests/conftest.py itself imports jax, so the check runs in a subprocess).
Nor does importing it load pandas, h5py or sklearn, which the machine
with the card does not have."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import ssdr_al_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBMODULES = sorted(
    m.name for m in pkgutil.walk_packages(ssdr_al_torch.__path__,
                                          "ssdr_al_torch."))


def test_every_submodule_is_listed():
    for name in ("ssdr_al_torch.ops.knn", "ssdr_al_torch.ops.gather",
                 "ssdr_al_torch.ops.chamfer", "ssdr_al_torch.kernels.build",
                 "ssdr_al_torch.models.randlanet", "ssdr_al_torch.config",
                 "ssdr_al_torch.data", "ssdr_al_torch.data.cloud",
                 "ssdr_al_torch.data.dataset", "ssdr_al_torch.data.ply",
                 "ssdr_al_torch.data.synthetic", "ssdr_al_torch.device",
                 "ssdr_al_torch.active.samplers",
                 "ssdr_al_torch.train.trainer",
                 "ssdr_al_torch.train.evaluator",
                 "ssdr_al_torch.train.metrics", "ssdr_al_torch.cli.common",
                 "ssdr_al_torch.cli.seed", "ssdr_al_torch.cli.al_loop",
                 "ssdr_al_torch.cli.evaluate",
                 "ssdr_al_torch.train.cross_val",
                 "ssdr_al_torch.utils.visualize",
                 "ssdr_al_torch.active.gcn", "ssdr_al_torch.ops.kcenter",
                 "ssdr_al_torch.cli.baseline",
                 "ssdr_al_torch.cli.max_dominant",
                 "ssdr_al_torch.ops.geof", "ssdr_al_torch.ops.grid_subsample",
                 "ssdr_al_torch.partition", "ssdr_al_torch.partition.cp",
                 "ssdr_al_torch.partition.superpoint",
                 "ssdr_al_torch.partition.sp_graph",
                 "ssdr_al_torch.partition.spg",
                 "ssdr_al_torch.partition.provider",
                 "ssdr_al_torch.data.prepare", "ssdr_al_torch.cli.prepare",
                 "ssdr_al_torch.cli.superpoint", "ssdr_al_torch.parallel",
                 "ssdr_al_torch.parallel.mesh",
                 "ssdr_al_torch.parallel.dryrun",
                 "ssdr_al_torch.parallel.agreement",
                 "ssdr_al_torch.train.flax_snapshot",
                 "ssdr_al_torch.kernels.counts",
                 "ssdr_al_torch.utils.logging",
                 "ssdr_al_torch.train.repeat_check",
                 "ssdr_al_torch.scripts",
                 "ssdr_al_torch.scripts.ablation",
                 "ssdr_al_torch.scripts.flagship"):
        assert name in SUBMODULES


@pytest.mark.parametrize("blocked", ["jax", "flax", "optax", "msgpack"])
def test_imports_without(blocked):
    code = (
        "import importlib, sys\n"
        f"sys.modules[{blocked!r}] = None\n"
        "import ssdr_al_torch\n"
        f"for m in {SUBMODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'ssdr_al_tpu') and "
        "sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("absent", ["pandas", "h5py", "sklearn"])
def test_imports_without_host_only_packages(absent):
    """Every submodule imports where `absent` cannot be imported, and
    importing them all loads none of pandas, h5py and sklearn (the
    partition's readers use numpy; its HDF5 files import h5py inside the
    function that needs it). Importing them builds no cut-pursuit library
    either (a fresh interpreter: other tests of a worker load it)."""
    code = (
        "import importlib, sys\n"
        f"sys.modules[{absent!r}] = None\n"
        "import ssdr_al_torch\n"
        f"for m in {SUBMODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('pandas', 'h5py', 'sklearn') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "from ssdr_al_torch.partition import cp\n"
        "assert cp._lib is None\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_importing_builds_nothing():
    """Importing the package loads (and so builds) no kernel library."""
    from ssdr_al_torch.kernels import build

    assert build._lib is None
