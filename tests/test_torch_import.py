"""ssdr_al_torch imports without jax and without ssdr_al_tpu: every
submodule, in a fresh interpreter where `import jax` fails
(tests/conftest.py itself imports jax, so the check runs in a subprocess)."""

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
                 "ssdr_al_torch.cli.max_dominant"):
        assert name in SUBMODULES


@pytest.mark.parametrize("blocked", ["jax", "flax", "optax"])
def test_imports_without(blocked):
    code = (
        "import importlib, sys\n"
        f"sys.modules[{blocked!r}] = None\n"
        "import ssdr_al_torch\n"
        f"for m in {SUBMODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ssdr_al_tpu') and "
        "sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_importing_builds_nothing():
    """Importing the package loads (and so builds) no kernel library."""
    from ssdr_al_torch.kernels import build

    assert build._lib is None
