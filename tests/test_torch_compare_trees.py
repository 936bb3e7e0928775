"""tools/compare_trees.py: each experiment of VARIANTS still applies to the
kernels' sources (every text it edits occurs exactly once), and the edited
tree's host build compiles and, where the edit touches no host-built code,
gives the kernels' results unchanged."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu_torch.tools import compare_trees as CT


@pytest.mark.parametrize("name", sorted(CT.VARIANTS))
def test_variant_applies(tmp_path, name):
    root = CT.make_variant(name, tmp_path)
    pkg = root / "spartacus_surface_tpu_torch"
    for rel, old, new in CT.VARIANTS[name]:
        text = (pkg / rel).read_text()
        assert new in text and old not in text.replace(new, ""), rel
    assert (pkg / "ops" / "cuda_build.py").exists()


@pytest.mark.parametrize("name", ["uv_once", "direct_reads"])
def test_variant_host_build_unchanged(tmp_path, name):
    """The copy-ahead runs only on the card, so these edits leave the host
    build's K2 bit for bit as it is (and it still compiles)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    libs = []
    for tree in (CT.THIS_TREE, CT.make_variant(name, tmp_path)):
        out = tmp_path / f"host-{len(libs)}.so"
        subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                        str(tree / "spartacus_surface_tpu_torch" / "csrc" / "host_check.cpp"),
                        "-o", str(out)], check=True)
        libs.append(ctypes.CDLL(str(out)))
    nreg, ns, L, C, S = 2, 4, 3, 5, 3
    dev = torch.device("cpu")
    args = (*CT.up_operands("sw", nreg, ns, L, C, S, torch.float64, dev, seed=3),
            torch.as_tensor(LegendreGauss(ns).hweight))
    kw = dict(nd=nreg * ns, ns=ns, nreg=nreg)
    got = [SK.launch_up(lib, *args, stream=None, **kw) for lib in libs]
    ref = SK.sw_up_sweep_plain(*args, **kw)
    for a, b, r in zip(*got, ref):
        assert torch.equal(a, b)
        assert np.isfinite(a.numpy()).all() and torch.allclose(a, r, rtol=1e-10, atol=1e-12)
