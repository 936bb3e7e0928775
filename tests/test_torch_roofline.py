"""The port's roofline tool (spartacus_surface_tpu_torch/tools/roofline.py)
and its probe kernels K6 (chained FMA) and K7 (memory stream), on the CPU:

* host build: csrc/host_check.cpp runs the K6 and K7 per-thread bodies on
  the CPU against their plain versions: K6 rtol 1e-4 in float32 (the
  kernel's fma rounds once a step, the plain mul + add twice, over 512
  steps) and 1e-12 in float64; K7 exactly;
* the work model: kernel_work against the counting build
  (csrc/host_count.cpp: the kernels' bodies on a double that counts its
  adds, subtracts, multiplies and divides) for K1 / K1d (SW and LW), K2,
  K3, K4 and K5 at five (nreg, ns), on the solver's operands from seeded
  example inputs with LW fields drawn per column, layer and band: within
  2 %;
* the JAX tool's _fma_matmul / _fma_solve (tools/roofline.py, imported by
  path; it imports JAX only inside its measuring functions) and the ratio
  of the two solve_work_models;
* without CUDA the tool's main exits nonzero and the probes raise;
* cuda (marked, skipped without a GPU): both probes on the card against
  their plain versions.
"""

import contextlib
import ctypes
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from spartacus_surface_tpu_torch.ops import cuda_build
from spartacus_surface_tpu_torch.ops import probe_kernels as PK
from spartacus_surface_tpu_torch.tools import roofline as RL
from test_torch_kernels import KERNELS, LAUNCH, build_host, capture

REPO = Path(__file__).resolve().parents[1]
COUNT_CONFIGS = ((1, 2), (2, 4), (3, 4), (1, 1), (2, 1), (3, 8))  # (nreg, ns)


def fma_tol(dtype):
    return dict(rtol=1e-4, atol=0.0) if dtype == np.float32 else dict(rtol=1e-12, atol=0.0)


@pytest.fixture(scope="module")
def host_lib():
    return build_host("host_check.cpp")


@pytest.fixture(scope="module")
def count_lib():
    lib = build_host("host_count.cpp")
    lib.count_threads.restype = ctypes.c_longlong
    return lib


@pytest.fixture(scope="module")
def captured():
    """{(nreg, ns): the solver's calls of each kernel wrapper} (float64)."""
    cache = {}

    def get(nreg, ns):
        if (nreg, ns) not in cache:
            cache[nreg, ns] = capture(pytest.MonkeyPatch(), nreg, ns, np.float64, "cpu")
        return cache[nreg, ns]
    return get


def jax_roofline():
    spec = importlib.util.spec_from_file_location("jax_roofline", REPO / "tools" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# K6, K7: host build and the CPU side of the wrappers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_host_built_fma_chain_matches_plain(host_lib, dtype):
    x = torch.as_tensor(np.random.default_rng(6).uniform(0.5, 1.5, (PK.FMA_ACC, 37))
                        .astype(dtype))
    got = PK.launch_fma(host_lib, x, RL.FMA_B, RL.FMA_C, stream=None)
    ref = PK.fma_chain_plain(x, RL.FMA_B, RL.FMA_C)
    assert got.isfinite().all() and (got > x + 300).all()  # 512 steps of ~0.75
    torch.testing.assert_close(got, ref, **fma_tol(dtype))


def test_host_built_copy_add_matches_plain(host_lib):
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(4247)
                        .astype(np.float32))  # 1,061 float4 groups + a tail of 3
    assert torch.equal(PK.launch_copy(host_lib, x, stream=None), PK.copy_add_plain(x))


def test_host_built_copy_add_into_out(host_lib):
    """K7 writes a preallocated output (out=, as torch.add(x, 1.0, out=o))
    exactly, ragged tail included, and returns it."""
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(4247)
                        .astype(np.float32))  # 1,061 float4 groups + a tail of 3
    out = torch.full_like(x, float("nan"))
    n7 = PK.copy_add.launches
    got = PK.launch_copy(host_lib, x, stream=None, out=out)
    assert got is out and torch.equal(out, PK.copy_add_plain(x))
    assert PK.copy_add.launches == n7 + 1


def test_probe_wrappers_on_cpu():
    """CPU tensors take the plain versions and build nothing; the wrappers
    check their operands."""
    x = torch.as_tensor(np.random.default_rng(8).uniform(0.5, 1.5, (PK.FMA_ACC, 5)))
    n6, n7 = PK.fma_chain.launches, PK.copy_add.launches
    assert torch.equal(PK.fma_chain(x, 0.5, 1.0), PK.fma_chain_plain(x, 0.5, 1.0))
    assert torch.equal(PK.copy_add(x.float()), x.float() + 1.0)
    assert (PK.fma_chain.launches, PK.copy_add.launches) == (n6, n7)
    assert cuda_build._libs == {}
    with pytest.raises(ValueError, match="shape"):
        PK.fma_chain(x[:3], 0.5, 1.0)
    with pytest.raises(TypeError, match="float32"):
        PK.copy_add(x)
    with pytest.raises(ValueError, match="contiguous"):
        PK.copy_add(x.float().t())
    y = x.float()
    out = torch.empty_like(y)
    assert PK.copy_add(y, out=out) is out and torch.equal(out, y + 1.0)
    with pytest.raises(ValueError, match="shape"):
        PK.copy_add(y, out=out[:3])
    with pytest.raises(ValueError, match="float64"):
        PK.copy_add(y, out=out.double())
    with pytest.raises(ValueError, match="contiguous"):
        PK.copy_add(y, out=torch.empty(y.shape[::-1]).t())


# ----------------------------------------------------------------------
# the work model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("nreg,ns", COUNT_CONFIGS)
def test_kernel_work_matches_counting_build(count_lib, captured, nreg, ns, kernel):
    """kernel_work's FLOPs of one call within 2 % of the counting build's
    total over the call's threads (K1 or K1d by is_structured; the count
    of each factory element follows its own doubling steps)."""
    a, k, _ = captured(nreg, ns)[kernel]
    count_lib.count_reset()
    LAUNCH[kernel](count_lib, *a, stream=None, **k)
    per_thread = (ctypes.c_longlong * count_lib.count_threads())()
    count_lib.count_per_thread(per_thread)
    counted = sum(per_thread)
    flops, nbytes = RL.kernel_work(kernel, *a, **k)
    assert counted > 0 and abs(flops - counted) <= 0.02 * counted, (flops, counted)
    assert nbytes > sum(t.nbytes for t in a)  # the results are written too


def test_factory_work_follows_the_doubling_steps(captured):
    """Each factory element pays for its own doubling steps: counted from
    the operands, which need more steps for the LW pseudo-beam than K = 0
    would give; with K given, the model is linear in K."""
    a, k, _ = captured(2, 4)["lw_layer_factory"]
    steps = RL.doubling_steps("lw_layer_factory", *a, **k)
    assert steps.shape == a[3].shape and steps.min() >= 0 and steps.max() > 0
    f0, b0 = RL.kernel_work("lw_layer_factory", *a, K=0, **k)
    f1, b1 = RL.kernel_work("lw_layer_factory", *a, K=1, **k)
    f, b = RL.kernel_work("lw_layer_factory", *a, **k)
    assert b0 == b1 == b
    assert f == pytest.approx(f0 + (f1 - f0) * float(steps.mean()))
    with pytest.raises(ValueError, match="unknown kernel"):
        RL.kernel_work("no_such_kernel", *a, **k)


def test_jax_work_formulas_are_kept():
    jrl = jax_roofline()
    for n in range(1, 14):
        for m in range(1, 20):
            assert RL._fma_solve(n, m) == jrl._fma_solve(n, m)
            for p in range(1, 6):
                assert RL._fma_matmul(n, p, m) == jrl._fma_matmul(n, p, m)


@pytest.mark.parametrize("config", RL.CONFIGS, ids=lambda c: c[0].split()[0])
def test_solve_work_model_near_the_jax_model(config):
    """The port counts its kernels as written; the JAX tool modelled the
    TPU kernels.  Per column the two agree within a factor 2."""
    _, nreg, ns, L, _ = config
    jflops, jbytes = jax_roofline().solve_work_model(nreg, ns, L)
    flops, nbytes = RL.solve_work_model(nreg, ns, L)
    assert 0.5 <= flops / jflops <= 2.0 and 0.5 <= nbytes / jbytes <= 2.0
    nd = nreg * ns
    assert RL.factory_fmas(nd, nreg, 3) == RL.layer_flops(nd, nreg, 3) / 2
    assert RL.sweep_fmas(nd, ns, nreg) > 0


def test_roofline_bound():
    """bound = max(FLOPs / FMA peak, bytes / bandwidth), against the
    published peaks or the measured ceilings where given."""
    pub = RL.roofline(67e9, 1.675e9, ms=4.0)  # 1 ms of f32 FMAs, 0.5 ms of bytes
    assert pub == {"bound_ms": pytest.approx(1.0), "bound_by": "operations",
                   "share": pytest.approx(0.25)}
    assert RL.roofline(34e9, 0, dtype=torch.float64)["bound_ms"] == pytest.approx(1.0)
    mem = RL.roofline(1e9, 6.7e9, fma_peak=1e12, hbm_bw=3.35e12)
    assert mem["bound_by"] == "bytes" and mem["bound_ms"] == pytest.approx(2.0)
    assert "share" not in mem


# ----------------------------------------------------------------------
# no CUDA: no numbers
# ----------------------------------------------------------------------

def test_roofline_main_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would measure it")
    for argv in ([], ["--measure-only"]):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert RL.main(argv) != 0
        assert "needs an NVIDIA GPU" in err.getvalue()
    for probe in (lambda: RL.measure_fma_peak(torch.float32, "cuda"),
                  lambda: RL.measure_hbm_bw("cuda"),
                  lambda: RL.measure_hbm_bw("cpu")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            probe()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_probes_match_plain(cuda_device, dtype):
    x = torch.as_tensor(np.random.default_rng(9).uniform(0.5, 1.5, (PK.FMA_ACC, 70001))
                        .astype(dtype), device=cuda_device)
    n6, n7 = PK.fma_chain.launches, PK.copy_add.launches
    got = PK.fma_chain(x, RL.FMA_B, RL.FMA_C)
    y = x.float().reshape(-1)[:-3]  # a ragged tail of 1
    streamed = PK.copy_add(y)
    torch.cuda.synchronize()
    assert (PK.fma_chain.launches, PK.copy_add.launches) == (n6 + 1, n7 + 1)
    torch.testing.assert_close(got, PK.fma_chain_plain(x, RL.FMA_B, RL.FMA_C),
                               **fma_tol(dtype))
    assert torch.equal(streamed, PK.copy_add_plain(y))
