"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, never moves work to the CPU when a device is missing, refuses
forward-mode gradients on the kernel route, needs no nvcc to import, and
chip_smoke.py fails without a GPU."""

import os
import shutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from spartacus_surface_tpu_torch.models import solver
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import example_arrays, example_inputs

REPO = Path(__file__).resolve().parents[1]

_IMPORT_AND_RUN = """
import sys
import numpy as np
import spartacus_surface_tpu_torch.models.dispatch as d
import spartacus_surface_tpu_torch.models.flux_utils
import spartacus_surface_tpu_torch.ops.cuda_build as cb
import spartacus_surface_tpu_torch.utils.convert
import spartacus_surface_tpu_torch.driver.duplicate_profiles
import spartacus_surface_tpu_torch.driver.main
import spartacus_surface_tpu_torch.driver.merge
import spartacus_surface_tpu_torch.driver.test_kernels
import spartacus_surface_tpu_torch.examples.retrieval
import spartacus_surface_tpu_torch.ops.assoc_adding
import spartacus_surface_tpu_torch.ops.probe_kernels
import spartacus_surface_tpu_torch.parallel.distributed
import spartacus_surface_tpu_torch.parallel.mesh
import spartacus_surface_tpu_torch.parallel.streaming
import spartacus_surface_tpu_torch.tools.roofline
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays
out = d.run_radsurf(Config(do_lw=False).consolidate(),
                    example_arrays(C=6, L=2, dtype=np.float64), "cpu")
assert float(out["sw_norm_dir"]["top_net"].abs().sum()) > 0
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "spartacus_surface_tpu" or m.startswith("spartacus_surface_tpu.")]
assert not bad, bad
assert cb._libs == {} and cb.build_seconds == {}
print("clean")
"""


def test_port_imports_no_jax_and_needs_no_nvcc(tmp_path):
    """Import every module (the CLI's, the merge's, parallel/'s and the
    roofline tool's too) and run run_radsurf on the CPU
    with no nvcc on PATH: no JAX (nor JAX-package) module is loaded and
    nothing is built."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    os.symlink(sys.executable, bin_dir / "python")
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_AND_RUN], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), PATH=str(bin_dir)))
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_missing_device_raises():
    """A CUDA device that is not there raises; nothing falls back to the CPU."""
    dev = (f"cuda:{torch.cuda.device_count()}" if torch.cuda.is_available()
           else "cuda")
    cfg = Config(do_lw=False).consolidate()
    with pytest.raises((RuntimeError, AssertionError)):
        run_radsurf(cfg, example_arrays(C=6, L=2), dev)
    src = SimpleNamespace(**example_inputs(C=2, L=2, S=1))
    with pytest.raises((RuntimeError, AssertionError)):
        to_canopy_inputs(src, dev)


def test_kernel_demo_defaults_to_the_card(capsys):
    """demo_sw / demo_lw called with no device run on the card: without
    CUDA they raise instead of running the plain versions on the CPU."""
    from spartacus_surface_tpu_torch.driver import test_kernels as demo
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK

    if torch.cuda.is_available():
        n_sw, n_lw = LK.layer_factory.dense_launches, LK.lw_layer_factory.launches
        assert demo.demo_sw() and demo.demo_lw()
        assert LK.layer_factory.dense_launches > n_sw
        assert LK.lw_layer_factory.launches > n_lw
        return
    for fn in (demo.demo_sw, demo.demo_lw):
        with pytest.raises((RuntimeError, AssertionError)):
            fn()
    assert "operators" not in capsys.readouterr().out


def test_kernel_route_refuses_gradients():
    """Forward-mode gradients are refused on the kernel route (no jvp, as
    the JAX package's custom_vjp has none), not silently dropped by the
    kernels; reverse mode goes through the route's autograd Function."""
    src = SimpleNamespace(**example_inputs(C=3, L=2, S=1, dtype=np.float64))
    inp = to_canopy_inputs(src, "cpu")
    opt = solver.SolverOptions(nreg=2, nstream=4, do_urban=True)
    with fwAD.dual_level():
        dual = replace(inp, veg_ext=fwAD.make_dual(
            inp.veg_ext, torch.ones_like(inp.veg_ext)))
        with pytest.raises(NotImplementedError, match="jvp"):
            solver.spartacus_sw(dual, opt, LegendreGauss(4))
    inp.veg_ext.requires_grad_(True)
    _, _, bc = solver.spartacus_sw(inp, opt, LegendreGauss(4))
    assert bc["top_albedo_dir"].grad_fn.name() == "_KernelRouteGradBackward"


def test_nvcc_absence_is_reported():
    from spartacus_surface_tpu_torch.ops import cuda_build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """chip_smoke.py exits nonzero and prints no result without a GPU, and
    in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
