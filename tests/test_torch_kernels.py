"""The hand-written kernels (K1 / K1d layer factory in its SW and LW modes,
K2 SW up-sweep, K3 fused SW down-sweep, K4 LW up-sweep, K5 fused LW
down-sweep) against their plain PyTorch versions on the same operands,
captured from the solver's kernel routes on seeded example inputs (LW facet
and Planck fields drawn per column, layer and band), for the four entry
configurations and the three 1-stream ones (where the factory is K1d).

* host build: csrc/host_check.cpp compiles the kernels' per-thread bodies
  with the host C++ compiler and runs them thread by thread on the CPU, so
  the kernels' indexing and algebra are checked here without a GPU; the
  K1d body is also held against the JAX package's layer_matrices;
* cuda (marked, skipped without a GPU): the nvcc-built kernels on the card;
* the sweeps K2-K5 (plain and host-built) against the JAX package's
  Pallas kernels in interpret mode.

Tolerances: float64 per-field max|diff| / max(1, max|plain|) <= 1e-9 for
all; float32 K1 elementwise rtol 2e-4 / atol 2e-5
(tests/test_pallas_layer.py:45), K2, K3 and K4 3e-5 per field
(tests/test_pallas_sweep.py:25), K5 2e-4 (the LW bar, :94).  A non-finite
value fails every comparison, here and in chip_smoke.py
(test_nan_output_fails_comparison).
"""

import ctypes
import hashlib
import importlib.util
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from spartacus_surface_tpu_torch.models import solver
from spartacus_surface_tpu_torch.ops import cuda_build
from spartacus_surface_tpu_torch.ops import layer_kernel as LK
from spartacus_surface_tpu_torch.ops import lw_sweep_kernels as LSK
from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu_torch.utils.inputs import example_inputs, random_lw_fields

ENTRY_CONFIGS = ((1, 2), (2, 4), (3, 4), (2, 8))
LARGE_CONFIGS = ((3, 8),)  # nd = 24: K1 at a team of 32 lanes on the card
ONE_STREAM_CONFIGS = ((1, 1), (2, 1), (3, 1))  # K1d in SW; and in LW at nreg 1
KERNELS = ("layer_factory", "sw_up_sweep", "sw_down_sweep_both",
           "lw_layer_factory", "lw_up_sweep", "lw_down_sweep_both")
PLAIN = {"layer_factory": LK.layer_factory_plain,
         "lw_layer_factory": LK.lw_layer_factory_plain,
         "sw_up_sweep": SK.sw_up_sweep_plain,
         "sw_down_sweep_both": SK.sw_down_sweep_plain,
         "lw_up_sweep": LSK.lw_up_sweep_plain,
         "lw_down_sweep_both": LSK.lw_down_sweep_plain}
SWEEP_TOL_F32 = {"sw_up_sweep": 3e-5, "sw_down_sweep_both": 3e-5,
                 "lw_up_sweep": 3e-5, "lw_down_sweep_both": 2e-4}


def lw_inputs(C, L, S, dtype, seed):
    """LW example fields with the facet and Planck fields drawn per column,
    layer and band."""
    return {**example_inputs(C=C, L=L, S=S, dtype=dtype, seed=seed, lw=True),
            **random_lw_fields(C, L, S, dtype, seed=seed)}


def capture(monkeypatch, nreg, ns, dtype, device, C=6, L=3, S=2, night=False):
    """Run the SW and LW kernel routes once; return {wrapper: (args, kwargs,
    result)}.  With night, every other column has the sun below the horizon
    (cos_sza 0, which the solver clamps to 1e-6)."""
    calls = {}
    for name in KERNELS:
        fn = getattr(solver, name)

        def rec(*a, _n=name, _fn=fn, **k):
            calls[_n] = (a, k, _fn(*a, **k))
            return calls[_n][2]
        monkeypatch.setattr(solver, name, rec)
    opt = solver.SolverOptions(nreg=nreg, nstream=ns, do_urban=True)
    for lw, fields in ((False, example_inputs(C=C, L=L, S=S, dtype=dtype,
                                              seed=nreg * ns)),
                       (True, lw_inputs(C, L, S, dtype, nreg * ns))):
        if night:
            fields["cos_sza"][::2] = 0.0
        inp = solver.CanopyInputs(**{k: torch.as_tensor(v, device=device)
                                     for k, v in fields.items()})
        solve = solver.spartacus_lw if lw else solver.spartacus_sw
        solve(inp, opt, LegendreGauss(ns), with_profiles=True)
    monkeypatch.undo()
    return calls


def field_err(ref, got):
    """Worst per-field max|got - ref| / max(1, max|ref|); inf if either side
    holds a non-finite value."""
    worst = 0.0
    for r, g in zip(ref, got):
        r, g = r.double().cpu(), g.double().cpu()
        if not (r.isfinite().all() and g.isfinite().all()):
            return math.inf
        worst = max(worst, (r - g).abs().max().item()
                    / max(1.0, r.abs().max().item()))
    return worst


def assert_matches_plain(launched, calls, f32):
    """launched: {wrapper: result} of the kernels on calls' operands."""
    for name in ("layer_factory", "lw_layer_factory"):
        a, k, _ = calls[name]
        ref = PLAIN[name](*a, **k)
        got = launched[name]
        assert set(got) == set(ref), (name, set(got) ^ set(ref))
        for n in ref:
            if f32:
                torch.testing.assert_close(got[n], ref[n], rtol=2e-4, atol=2e-5)
            else:
                assert field_err([ref[n]], [got[n]]) <= 1e-9, (name, n)
    for name, tol in SWEEP_TOL_F32.items():
        a, k, _ = calls[name]
        err = field_err(PLAIN[name](*a, **k), launched[name])
        assert err <= (tol if f32 else 1e-9), (name, err)


# ----------------------------------------------------------------------
# host build of the kernel bodies
# ----------------------------------------------------------------------

def build_host(source):
    """Build csrc/<source> (host_check.cpp, host_count.cpp) with the host C++
    compiler into build/host/, cached by the hash of the sources; skips
    where there is no host compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip(f"no host C++ compiler to build csrc/{source}")
    srcs = sorted(cuda_build.CSRC.glob("*.cu*")) + [cuda_build.CSRC / source]
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in srcs)).hexdigest()[:12]
    out = cuda_build.BUILD_DIR.parent / "host" / f"{Path(source).stem}-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                        str(cuda_build.CSRC / source), "-o", str(tmp)], check=True)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def host_lib():
    return build_host("host_check.cpp")


LAUNCH = {"layer_factory": LK.launch, "lw_layer_factory": LK.launch_lw,
          "sw_up_sweep": SK.launch_up, "sw_down_sweep_both": SK.launch_down,
          "lw_up_sweep": LSK.launch_up, "lw_down_sweep_both": LSK.launch_down}


def host_launch(host_lib, calls):
    """{kernel: result} of the host-built kernels on calls' operands."""
    launched = {}
    for name in KERNELS:
        a, k, _ = calls[name]
        kw = dict(k, chunk=5) if "factory" in name else k  # ragged chunks
        launched[name] = LAUNCH[name](host_lib, *a, stream=None, **kw)
    return launched


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nreg,ns", ENTRY_CONFIGS + ONE_STREAM_CONFIGS + LARGE_CONFIGS)
def test_host_built_kernels_match_plain(host_lib, monkeypatch, nreg, ns, dtype):
    calls = capture(monkeypatch, nreg, ns, dtype, "cpu")
    assert_matches_plain(host_launch(host_lib, calls), calls, dtype == np.float32)


@pytest.mark.parametrize("nreg,ns", [(2, 1), (3, 1), (2, 4), (1, 1)])
def test_host_built_factory_float32_accuracy(host_lib, monkeypatch, nreg, ns):
    """In float32 each factory output of K1 / K1d is as close to the float64
    answer as the plain version's, within a factor 2 plus 1e-6 (at 1 stream
    the LW elements take ~8 doubling steps, which amplify any rounding of
    the thin-layer blocks)."""
    calls = capture(monkeypatch, nreg, ns, np.float32, "cpu", C=150, L=4, S=2)
    launched = host_launch(host_lib, calls)
    for name in ("layer_factory", "lw_layer_factory"):
        a, k, _ = calls[name]
        truth = PLAIN[name](*(x.double() for x in a), **k)
        plain = PLAIN[name](*a, **k)
        for n in truth:
            err = lambda x: (x[n].double() - truth[n]).abs().max().item()
            assert err(launched[name]) <= 2 * err(plain) + 1e-6, (name, n)


class _Recorder:
    """A library whose functions record each call's arguments and run the
    host build's."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append((name, args))
            return fn(*args)
        setattr(self, name, call)
        return call


@pytest.mark.parametrize("nreg,ns", [(2, 4), (1, 1)])
@pytest.mark.parametrize("chunk", [1, 5, 65536, 0])
@pytest.mark.parametrize("mode", ["sw", "lw"])
def test_factory_launch_has_no_workspace(host_lib, monkeypatch, mode, chunk, nreg, ns):
    """K1 (nreg, ns = 2, 4) and K1d (1, 1: both modes dense) launch once
    per call whatever `chunk` is, over every element, after one order pass,
    with no workspace (a null pointer), their order and launch
    configuration passed in, and nothing allocated through the operands but
    their outputs and the order pass's int32 [L, B] keys; the order is the
    argsort's int64 [L*B] permutation (with the keys, 12 bytes an element
    beside the outputs, freed when the launch returns)."""
    calls = capture(monkeypatch, nreg, ns, np.float64, "cpu")
    kind = "" if ns > 1 else "_dense"
    cuda_build.bind(host_lib, f"layer_factory{kind}_f64", LK.FACTORY_ARGTYPES)
    cuda_build.bind(host_lib, "factory_order_f64", LK.ORDER_ARGTYPES)
    cuda_build.bind(host_lib, f"layer_factory{kind}_config_f64",
                    [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_void_p])
    lib = _Recorder(host_lib)
    allocated = []
    new_empty = torch.Tensor.new_empty
    monkeypatch.setattr(torch.Tensor, "new_empty", lambda t, shape, **kw: (
        allocated.append((tuple(shape), str(kw.get("dtype", t.dtype)))),
        new_empty(t, shape, **kw))[1])
    orders, element_order = [], LK.element_order
    monkeypatch.setattr(LK, "element_order", lambda keys: (
        orders.append(element_order(keys)), orders[-1])[1])
    counter = "launches" if ns > 1 else "dense_launches"
    n1, nlw = (getattr(w, counter) for w in (LK.layer_factory, LK.lw_layer_factory))
    norder = LK.layer_factory.order_launches
    a, k, ref = calls[f"{'' if mode == 'sw' else 'lw_'}layer_factory"]
    assert LK.is_structured(k["nd"], k.get("ndir", 1)) == (ns > 1)
    got = LAUNCH[("" if mode == "sw" else "lw_") + "layer_factory"](
        lib, *a, stream=None, **dict(k, chunk=chunk))
    monkeypatch.undo()
    launches = [args for name, args in lib.calls if name == f"layer_factory{kind}_f64"]
    assert len(launches) == 1 and len(launches[0]) == len(LK.FACTORY_ARGTYPES)
    L, _, B = a[0].shape
    assert launches[0][13] is None and launches[0][-3:-2] == (L * B,)  # ws, n
    assert launches[0][14] is not None  # the order
    assert launches[0][-2] is not None  # the launch configuration
    assert [name for name, _ in lib.calls].count("factory_order_f64") == 1
    assert getattr(LK.layer_factory, counter) == n1 + 1
    assert getattr(LK.lw_layer_factory, counter) == nlw + (mode == "lw")
    assert LK.layer_factory.order_launches == norder + 1
    rows = LK.out_rows(k["nd"], k.get("ndir", 1))
    assert sorted(allocated) == sorted([((L, B), "torch.int32")] + [
        ((L, rows[n], B), "torch.float64") for n in LK.out_names(mode == "sw")])
    assert len(orders) == 1 and orders[0].dtype == torch.int64
    assert torch.equal(orders[0].sort().values, torch.arange(L * B))
    assert all(field_err([ref[n]], [got[n]]) <= 1e-9 for n in ref)


@pytest.mark.parametrize("mode", ["sw", "lw", "sw_down", "lw_down"])
def test_sweep_launch_has_no_workspace(host_lib, monkeypatch, mode):
    """K2 / K4 (mode "sw" / "lw") and K3 / K5 ("sw_down" / "lw_down")
    launch once per call with no workspace (K2 / K4: a null pointer; K3 /
    K5: no such argument), their launch configuration passed in, and
    nothing allocated but their results (stacks and top; outs and fin); the
    results match the plain version (1e-9)."""
    calls = capture(monkeypatch, 2, 4, np.float64, "cpu")
    name, mod = {"sw": ("sw_up_sweep", SK), "lw": ("lw_up_sweep", LSK),
                 "sw_down": ("sw_down_sweep_both", SK),
                 "lw_down": ("lw_down_sweep_both", LSK)}[mode]
    symbol = name.replace("_both", "")
    down = mode.endswith("down")
    cuda_build.bind(host_lib, f"{symbol}_f64", mod.DOWN_ARGTYPES if down else mod.UP_ARGTYPES)
    cuda_build.bind(host_lib, f"{symbol}_config_f64",
                    [ctypes.c_int] * (5 if down else 3) + [ctypes.c_longlong, ctypes.c_void_p])
    lib = _Recorder(host_lib)
    allocated = []
    new_empty = torch.Tensor.new_empty
    monkeypatch.setattr(torch.Tensor, "new_empty", lambda t, shape, **kw: (
        allocated.append(tuple(shape)), new_empty(t, shape, **kw))[1])
    n0 = getattr(solver, name).launches
    a, k, ref = calls[name]
    got = LAUNCH[name](lib, *a, stream=None, **k)
    monkeypatch.undo()
    launches = [args for n, args in lib.calls if n == f"{symbol}_f64"]
    argtypes = mod.DOWN_ARGTYPES if down else mod.UP_ARGTYPES
    assert len(launches) == 1 and len(launches[0]) == len(argtypes)
    if not down:
        assert launches[0][13 if mode == "sw" else 12] is None
    assert launches[0][-2] is not None  # the launch configuration
    assert getattr(solver, name).launches == n0 + 1
    L, _, B = a[0].shape
    nd, ns, nreg = k["nd"], k["ns"], k["nreg"]
    if mode == "sw":
        rows = (SK.sw_stack_rows(nd, ns, nreg), nd * nd + nd * nreg)
    elif mode == "lw":
        rows = (LSK.lw_stack_rows(nd, ns, nreg), nd * nd + nd)
    elif mode == "sw_down":
        rows = (sum(len(SK.sw_out_rows(wd, k["do_urban"], nreg, k["with_profiles"]))
                    for wd in SK.MODES), nreg + 2 * nd)
    else:
        rows = (2 * len(LSK.lw_out_rows(k["do_urban"], nreg, k["with_profiles"])), 2 * nd)
    assert sorted(allocated) == sorted([(L, rows[0], B), (rows[1], B)])
    assert field_err(ref, got) <= 1e-9


def _pallas_up_operands(mode, nreg, ns, L, C, S, seed):
    """Seeded float64 operands of one up-sweep call in the JAX Pallas
    kernel's layout ([B, L, rows], uov / vov per element, grd [B, rows])
    and in the port's ([L, rows, B], uov / vov per column, grd [rows, B])."""
    rng = np.random.default_rng(seed)
    nd, nregp, B = nreg * ns, nreg + 1, C * S
    u = lambda *shape, lo=0.0, hi=1.0: rng.uniform(lo, hi, shape)
    lay = {"R": u(B, L, nd * nd, hi=0.5 / nd), "T": u(B, L, nd * nd, hi=0.5 / nd)}
    if mode == "sw":
        lay.update(E=u(B, L, nreg * nreg), Sup=u(B, L, nd * nreg, hi=0.2),
                   Sdn=u(B, L, nd * nreg, hi=0.2))
    else:
        lay.update(p=u(B, L, nd, hi=50.0))
    cols = {"uov": u(C, L, nreg * nregp, hi=1.0 / nregp),
            "vov": u(C, L, nregp * nreg, hi=1.0 / nregp)}
    if mode == "sw":
        per_layer = {"ralb": u(B, L, 1), "ralbd": u(B, L, 1)}
        grd = np.stack([u(B), u(B), u(B, lo=0.2)], axis=1)
    else:
        per_layer = {"reps": u(B, L, 1, lo=0.5), "remit": u(B, L, 1, hi=400.0),
                     "exposed": u(B, L, 1)}
        grd = np.concatenate([u(B, 1, lo=0.5), u(B, 1, hi=400.0), u(B, nreg)], axis=1)
    jax_args = ([*lay.values()] + [np.repeat(c, S, axis=0) for c in cols.values()]
                + [*per_layer.values()] + [grd])
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))
    port_args = ([t(x.transpose(1, 2, 0)) for x in lay.values()]
                 + [t(c.transpose(1, 2, 0)) for c in cols.values()]
                 + [t(x[..., 0].T) for x in per_layer.values()] + [t(grd.T)])
    return jax_args, port_args


@pytest.mark.parametrize("mode", ["sw", "lw"])
def test_up_sweeps_match_pallas_kernels(host_lib, mode):
    """The port's plain K2 / K4 and their host-built team bodies (a team of
    one lane) against the JAX package's Pallas kernels themselves
    (pallas_sweep.sw_up_sweep / lw_up_sweep, interpret mode), float64,
    B = 1024 (the kernels' tile), L = 2, (nreg, ns) = (2, 4): every stack
    row and the top within 1e-12 per field after the relayout."""
    import importlib

    PS = importlib.import_module("spartacus_surface_tpu.ops.pallas_sweep")
    nreg, ns, L, C, S = 2, 4, 2, 512, 2
    nd = nreg * ns
    jax_args, port_args = _pallas_up_operands(mode, nreg, ns, L, C, S, seed=nreg * ns)
    hw = LegendreGauss(ns).hweight
    kw = dict(nd=nd, ns=ns, nreg=nreg)
    fn = PS.sw_up_sweep if mode == "sw" else PS.lw_up_sweep
    stacks, top = fn(*jax_args, hw=tuple(float(h) for h in hw), interpret=True, **kw)
    ref = (torch.as_tensor(np.asarray(stacks).transpose(1, 2, 0).copy()),
           torch.as_tensor(np.asarray(top).T.copy()))
    args = (*port_args, torch.as_tensor(hw))
    name = f"{mode}_up_sweep"
    plain = PLAIN[name](*args, **kw)
    team = LAUNCH[name](host_lib, *args, stream=None, **kw)
    for got in (plain, team):
        assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
        assert field_err(ref, got) <= 1e-12


def _pallas_down_operands(mode, nreg, ns, L, C, S, seed, up_sweep):
    """Seeded float64 operands of one down-sweep call (K3: mode "sw", K5:
    "lw") in the JAX Pallas kernel's layout and in the port's, as
    _pallas_up_operands, and the quadrature; the stacks from
    up_sweep(jax_args, port_args, hw) ([B, L, rows], an up-sweep on the same
    layer operators)."""
    rng = np.random.default_rng(seed + 1)
    nd, B = nreg * ns, C * S
    nod = max(nreg - 1, 1)
    u = lambda *shape, hi=1.0: rng.uniform(0.0, hi, shape)
    up_jax, up_port = _pallas_up_operands(mode, nreg, ns, L, C, S, seed)
    lg = LegendreGauss(ns)
    quad = dict(hw=tuple(map(float, lg.hweight)), rmu=tuple(map(float, 1.0 / lg.mu)),
                rtan=tuple(map(float, lg.tan_ang)))
    stacks = np.asarray(up_sweep(up_jax, up_port, lg.hweight))
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))
    port = lambda x: t(x.transpose(1, 2, 0))
    if mode == "sw":
        R, T, E, _, Sdn, _, vov = up_jax[:7]
        ops = dict(idir=u(B, L, nreg * nreg, hi=0.5), idif=u(B, L, nd * nd, hi=0.5 / nd),
                   idd=u(B, L, nd * nreg, hi=0.2))
        aux = u(B, L, nreg + nod + 3)
        zcos = up_jax[-1][:, 2]
        jax_args = (R, T, E, Sdn, *ops.values(), stacks, vov, aux, zcos[:, None])
        port_args = (*up_port[:3], up_port[4], *map(port, ops.values()), port(stacks),
                     up_port[6], port(aux), t(zcos))
    else:
        R, T, p = up_jax[:3]
        vov = up_jax[4]
        idif, isrc = u(B, L, nd * nd, hi=0.5 / nd), u(B, L, nd, hi=50.0)
        aux = np.concatenate([u(B, L, nreg + nod + 3), u(B, L, 4, hi=400.0)], axis=2)
        jax_args = (R, T, p, idif, isrc, stacks, vov, aux)
        port_args = (*up_port[:3], port(idif), port(isrc), port(stacks), up_port[4],
                     port(aux))
    port_args += tuple(torch.as_tensor(np.asarray(x)) for x in
                       (lg.hweight, 1.0 / lg.mu, lg.tan_ang))
    return jax_args, port_args, quad


@pytest.mark.parametrize("mode", ["sw", "lw"])
def test_down_sweeps_match_pallas_kernels(host_lib, mode):
    """The port's plain K3 / K5 and their host-built team bodies (a team of
    one lane, NaN-filled slab) against the JAX package's Pallas kernels
    themselves (pallas_sweep.sw_down_sweep_both / lw_down_sweep_both,
    interpret mode), float64, B = 1024 (the kernels' tile), L = 2, (nreg,
    ns) = (2, 4), urban, with profiles, the stacks from the JAX Pallas
    up-sweep: every out row and fin within 1e-12 per field after the
    relayout."""
    import importlib

    PS = importlib.import_module("spartacus_surface_tpu.ops.pallas_sweep")
    nreg, ns, L, C, S = 2, 4, 2, 512, 2
    nd = nreg * ns
    up = PS.sw_up_sweep if mode == "sw" else PS.lw_up_sweep
    jax_args, args, quad = _pallas_down_operands(
        mode, nreg, ns, L, C, S, nreg * ns, lambda a, _, hw: up(
            *a, hw=tuple(map(float, hw)), nd=nd, ns=ns, nreg=nreg, interpret=True)[0])
    kw = dict(nd=nd, ns=ns, nreg=nreg, do_urban=True, with_profiles=True)
    fn = PS.sw_down_sweep_both if mode == "sw" else PS.lw_down_sweep_both
    outs, fins = fn(*jax_args, interpret=True, **quad, **kw)
    if mode == "sw":
        names = [SK.sw_out_rows(wd, True, nreg, True) for wd in SK.MODES]
    else:
        names = [LSK.lw_out_rows(True, nreg, True)] * 2
    rows = [np.asarray(o[n]).T for o, ns_ in zip(outs, names) for n in ns_]
    ref = (torch.as_tensor(np.stack(rows, axis=1)),
           torch.as_tensor(np.concatenate([np.asarray(f) for f in fins], axis=1).T.copy()))
    name = f"{mode}_down_sweep_both"
    plain = PLAIN[name](*args, **kw)
    team = LAUNCH[name](host_lib, *args, stream=None, **kw)
    for got in (plain, team):
        assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
        assert field_err(ref, got) <= 1e-12


@pytest.mark.parametrize("nd,ndir", [(40, 1), (36, 3)])
def test_host_built_factory_wider_than_a_warp(host_lib, nd, ndir):
    """K1 at nd > 32 (on the card a team of 32 lanes with several rows a
    lane, and products wider than a lane's registers) against the plain
    version, in float64 at 1e-9 per field.  The point is the indexing:
    these random operands are not diagonally dominant at this width, and in
    float32 the pivot-free Schur solve loses up to 4e-4 on int_diff where
    the plain version's pivoted one loses 3e-6."""
    ops = _random_gammas(np.random.default_rng(nd), 2, 5, nd, ndir, np.float64)
    got = LK.launch(host_lib, *ops, nd=nd, ndir=ndir, n_double=30, chunk=3,
                    stream=None)
    ref = LK.layer_factory_plain(*ops, nd=nd, ndir=ndir)
    assert set(got) == set(ref)
    for k in ref:
        assert field_err([ref[k]], [got[k]]) <= 1e-9, k


def _soa(x, L, B):
    """[L*B, n, m] numpy -> [L, n*m, B] tensor (element e = l*B + b)."""
    return torch.as_tensor(np.ascontiguousarray(
        x.reshape(L, B, -1).transpose(0, 2, 1)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode,nreg", [("sw", 1), ("sw", 2), ("sw", 3),
                                       ("lw", 1)])
def test_host_built_dense_factory_matches_jax(host_lib, mode, nreg, dtype):
    """K1d's body (1 stream per hemisphere: nd = nreg) against the JAX
    package's layer_matrices / lw_layer_matrices (the XLA route the TPU
    kernel is held to) on the same operands: f64 1e-9 per field, f32
    elementwise rtol 2e-4 / atol 2e-5 (tests/test_pallas_layer.py:45)."""
    import importlib

    from tests.test_layer_matrices import make_gammas

    jlm = importlib.import_module("spartacus_surface_tpu.ops.layer_matrices")
    rng = np.random.default_rng(nreg)
    L, B = 2, 5
    g0, g1, g2, g3 = (np.stack(x).astype(dtype) for x in zip(
        *(make_gammas(rng, 1, nreg) for _ in range(L * B))))
    dz = rng.uniform(0.3, 10.0, L * B).astype(dtype)
    assert not LK.is_structured(nreg, nreg if mode == "sw" else 1)
    if mode == "sw":
        ref = jlm.layer_matrices(g0, g1, g2, g3, dz, n_double=30)
        got = LK.launch(host_lib, *(_soa(g, L, B) for g in (g0, g1, g2, g3)),
                        torch.as_tensor(dz.reshape(L, B)), nd=nreg, ndir=nreg,
                        n_double=30, chunk=3, stream=None)
    else:
        b = rng.uniform(50.0, 400.0, (L * B, nreg)).astype(dtype)
        ref = jlm.lw_layer_matrices(g1, g2, b, dz, n_double=30)
        got = LK.launch_lw(host_lib, _soa(g1, L, B), _soa(g2, L, B),
                           _soa(b, L, B), torch.as_tensor(dz.reshape(L, B)),
                           nd=nreg, n_double=30, chunk=3, stream=None)
    assert set(got) == set(ref)
    for key in ref:
        r = torch.as_tensor(np.asarray(ref[key]).reshape(L, B, -1)
                            .transpose(0, 2, 1).copy())
        if dtype == np.float32:
            torch.testing.assert_close(got[key], r, rtol=2e-4, atol=2e-5)
        else:
            assert field_err([r], [got[key]]) <= 1e-9, key


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kernel", KERNELS)
def test_nan_output_fails_comparison(host_lib, monkeypatch, kernel, dtype):
    """One NaN planted in one kernel's output fails this file's comparison
    and chip_smoke.py's gate for that kernel, and only for that one."""
    calls = capture(monkeypatch, 2, 4, dtype, "cpu")
    launched = host_launch(host_lib, calls)
    out = launched[kernel]
    field = {"layer_factory": lambda: out["int_dir_diff"],
             "lw_layer_factory": lambda: out["int_source"]}.get(
                 kernel, lambda: out[0])()
    field.view(-1)[field.numel() // 2] = float("nan")
    with pytest.raises(AssertionError):
        assert_matches_plain(launched, calls, dtype == np.float32)

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = smoke.compare_kernels(
        {n: [(*calls[n][:2], launched[n])] for n in KERNELS},
        torch.float32 if dtype == np.float32 else torch.float64, LK, SK, LSK)
    # a kernel of smoke.KERNELS is compared where one of its calls ran on it
    ran = [any(smoke.runs_on(factory, calls[n][1], LK) for n in names)
           for *_, names, factory in smoke.KERNELS]
    bad = [r and kernel in k[4] for r, k in zip(ran, smoke.KERNELS)]
    assert [ok for _, ok in res] == [(not b) if r else None
                                     for b, r in zip(bad, ran)]
    assert res[bad.index(True)][0] == math.inf


# ----------------------------------------------------------------------
# the CPU side of the wrappers
# ----------------------------------------------------------------------

def test_wrappers_take_plain_versions_on_cpu(monkeypatch):
    calls = capture(monkeypatch, 2, 4, np.float64, "cpu")
    a, k, got = calls["layer_factory"]
    ref = LK.layer_factory_plain(*a, **k)
    assert all(torch.equal(got[n], ref[n]) for n in LK.OUT_NAMES)
    for name in ("sw_down_sweep_both", "lw_up_sweep", "lw_down_sweep_both"):
        a, k, got = calls[name]
        assert all(torch.equal(x, y) for x, y in zip(got, PLAIN[name](*a, **k)))
    a, k, got = calls["lw_layer_factory"]
    ref = LK.lw_layer_factory_plain(*a, **k)
    assert all(torch.equal(got[n], ref[n]) for n in LK.LW_OUT_NAMES)
    assert cuda_build._libs == {}  # nothing was built or loaded


def test_lw_factory_skips_direct_integrals(host_lib, monkeypatch):
    """In its LW mode (gamma0 = 0) K1 neither computes nor returns the
    direct-beam integrals, and every output it returns is finite."""
    calls = capture(monkeypatch, 2, 4, np.float32, "cpu")
    a, k, _ = calls["lw_layer_factory"]
    g0, g3 = LK._lw_operands(a[0], a[2])
    lay = LK.launch(host_lib, g0, a[0], a[1], g3, a[3], nd=k["nd"], ndir=1,
                    n_double=k["n_double"], chunk=7, stream=None,
                    int_direct=False)
    assert set(lay) == {"R", "T", "E", "Sup", "Sdn", "int_diff"}
    assert all(v.isfinite().all() for v in lay.values())
    assert not g0.any()  # the pseudo-beam: gamma0 = 0 is singular


def test_wrappers_check_operands(monkeypatch):
    calls = capture(monkeypatch, 2, 4, np.float64, "cpu")
    a, k, _ = calls["sw_up_sweep"]
    with pytest.raises(ValueError, match="shape"):
        SK.sw_up_sweep(a[0][:, :-1], *a[1:], **k)
    with pytest.raises(ValueError, match="float32"):
        SK.sw_up_sweep(a[0].float(), *a[1:], **k)
    with pytest.raises(ValueError, match="C \\* S"):  # 12 elements, 5 columns
        SK.sw_up_sweep(*a[:5], a[5][..., :5].contiguous(),
                       a[6][..., :5].contiguous(), *a[7:], **k)
    a, k, _ = calls["layer_factory"]
    with pytest.raises(ValueError, match="contiguous"):
        LK.layer_factory(a[0], a[1].transpose(0, 1).contiguous().transpose(0, 1),
                         *a[2:], **k)
    with pytest.raises(TypeError, match="dtype"):
        LK.layer_factory(*(x.half() for x in a), **k)
    a, k, _ = calls["lw_layer_factory"]
    with pytest.raises(ValueError, match="shape"):
        LK.lw_layer_factory(a[0], a[1], a[2][:, :-1].contiguous(), a[3], **k)
    a, k, _ = calls["lw_up_sweep"]
    with pytest.raises(ValueError, match="shape"):  # grd without frac0
        LSK.lw_up_sweep(*a[:8], a[8][:2].contiguous(), a[9], **k)
    with pytest.raises(ValueError, match="float32"):
        LSK.lw_up_sweep(a[0].float(), *a[1:], **k)
    a, k, _ = calls["lw_down_sweep_both"]
    with pytest.raises(ValueError, match="shape"):  # aux without sub_wall
        LSK.lw_down_sweep_both(*a[:7], a[7][:, :-1].contiguous(), *a[8:], **k)
    with pytest.raises(ValueError, match="C \\* S"):  # 12 elements, 5 columns
        LSK.lw_down_sweep_both(*a[:6], a[6][..., :5].contiguous(), *a[7:], **k)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _counters(nreg, ns):
    """The launch counters a SW + LW solve at (nreg, ns) raises: K1 or K1d
    (the SW factory has ndir = nreg, the LW one ndir = 1), and K2-K5."""
    nd = nreg * ns
    sw = "launches" if LK.is_structured(nd, nreg) else "dense_launches"
    lw = "launches" if LK.is_structured(nd, 1) else "dense_launches"
    return ((LK.layer_factory, sw), (LK.lw_layer_factory, lw),
            (SK.sw_up_sweep, "launches"), (SK.sw_down_sweep_both, "launches"),
            (LSK.lw_up_sweep, "launches"), (LSK.lw_down_sweep_both, "launches"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nreg,ns", ENTRY_CONFIGS + ONE_STREAM_CONFIGS + LARGE_CONFIGS)
def test_cuda_kernels_match_plain(cuda_device, monkeypatch, nreg, ns, dtype):
    counters = _counters(nreg, ns)
    before = [getattr(w, c) for w, c in counters]
    calls = capture(monkeypatch, nreg, ns, dtype, cuda_device, C=300, L=4, S=2)
    torch.cuda.synchronize()
    assert all(getattr(w, c) > n for (w, c), n in zip(counters, before))
    assert_matches_plain({n: c[2] for n, c in calls.items()}, calls,
                         dtype == np.float32)


def _random_gammas(rng, L, B, nd, ndir, dtype):
    """Seeded, SPARTACUS-like [L, rows, B] operands: extinction on the
    diagonals of g0 and g1, weaker exchange and scattering off them."""
    def op(n, m, diag, off):
        a = off * rng.uniform(0.0, 1.0, (L, B, n, m))
        k = min(n, m)
        a[..., range(k), range(k)] = diag * rng.uniform(0.2, 1.0, (L, B, k))
        return torch.as_tensor(a.reshape(L, B, n * m).transpose(0, 2, 1)
                               .astype(dtype).copy())
    return (op(ndir, ndir, -1.5, 0.05), op(nd, nd, -2.0, 0.1),
            op(nd, nd, 0.4, 0.05), op(nd, ndir, 0.3, 0.05),
            torch.as_tensor(rng.uniform(0.3, 8.0, (L, B)).astype(dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nd,ndir", [(1, 1), (2, 2), (3, 3), (2, 4)])
def test_cuda_dense_factory_launches(cuda_device, nd, ndir, dtype):
    """Where the structured factory does not apply, K1d launches once over
    every element whatever `chunk` is (its own counter rises, K1's does
    not) and matches the plain version."""
    assert not LK.is_structured(nd, ndir)
    ops = [x.to(cuda_device) for x in
           _random_gammas(np.random.default_rng(nd), 3, 257, nd, ndir, dtype)]
    n1, nd1 = LK.layer_factory.launches, LK.layer_factory.dense_launches
    got = LK.layer_factory(*ops, nd=nd, ndir=ndir, chunk=500)
    torch.cuda.synchronize()
    assert LK.layer_factory.dense_launches == nd1 + 1  # 771 elements, one launch
    assert LK.layer_factory.launches == n1
    ref = LK.layer_factory_plain(*ops, nd=nd, ndir=ndir)
    assert set(got) == set(ref)
    for k in ref:
        if dtype == np.float32:
            torch.testing.assert_close(got[k], ref[k], rtol=2e-4, atol=2e-5)
        else:
            assert field_err([ref[k]], [got[k]]) <= 1e-9, k


def _check_ragged_batch(monkeypatch, device, nreg, ns, ts, dtype, names):
    """The sweeps `names` (wrapper name, module) as team kernels on a batch
    of 37 columns x 3 bands (111 elements: not a multiple of the teams of a
    block or of a warp), at team size ts: against their plain versions
    (float32 3e-5 per field, K5 2e-4; float64 1e-9); the launch shape: a team
    of the power of two >= nd (at least 2) lanes, whole warps of teams,
    shared memory of the slabs and of the copy-ahead (K2 / K4: two layers'
    operands a team; K3 / K5: blocks of whole 32-byte sectors, at least 8
    f32 / 4 f64 elements, where such a block fits), no scratch."""
    calls = capture(monkeypatch, nreg, ns, dtype, device, C=37, L=3, S=3)
    for name, mod in names:
        a, k, _ = calls[name]
        n = getattr(solver, name).launches
        got = getattr(mod, name)(*a, **k)
        torch.cuda.synchronize()
        assert getattr(solver, name).launches == n + 1
        err = field_err(PLAIN[name](*a, **k), got)
        assert err <= (SWEEP_TOL_F32[name] if dtype == np.float32 else 1e-9), (name, err)
        lib = cuda_build.load("sw_sweeps" if name.startswith("sw") else "lw_sweeps")
        if "down" in name:
            c = SK.down_config(lib, name.replace("_both", ""), k["nd"], k["ns"], k["nreg"],
                               k["do_urban"], k["with_profiles"], a[0].shape[2], a[0].dtype)
            assert ts == 32 or c["teams_per_block"] * a[0].element_size() >= 32, c
        else:
            c = SK.up_config(lib, name, k["nd"], k["ns"], k["nreg"], a[0].shape[2],
                             a[0].dtype)
        assert c["team_size"] == ts and c["threads_per_block"] % 32 == 0, c
        assert c["blocks_per_sm"] >= 1 and c["registers"] > 0, c
        assert c["scratch_elements"] == 0 and not c["global_slab"] and not c["fallback"], c
        assert c["grid"] == -(-111 // c["teams_per_block"]), c
        assert c["smem_per_block"] > c["teams_per_block"] * c["slab_bytes"], c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nreg,ns,ts", [(1, 1, 2), (2, 4, 8), (3, 4, 16), (3, 8, 32)])
def test_cuda_up_sweeps_ragged_batch(cuda_device, monkeypatch, nreg, ns, ts, dtype):
    """K2 and K4 on a ragged batch at team sizes 2 to 32 (_check_ragged_batch)."""
    _check_ragged_batch(monkeypatch, cuda_device, nreg, ns, ts, dtype,
                        (("sw_up_sweep", SK), ("lw_up_sweep", LSK)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nreg,ns,ts", [(1, 1, 2), (2, 4, 8), (3, 4, 16), (3, 8, 32)])
def test_cuda_down_sweeps_ragged_batch(cuda_device, monkeypatch, nreg, ns, ts, dtype):
    """K3 and K5 on a ragged batch at team sizes 2 to 32 (_check_ragged_batch)."""
    _check_ragged_batch(monkeypatch, cuda_device, nreg, ns, ts, dtype,
                        (("sw_down_sweep_both", SK), ("lw_down_sweep_both", LSK)))


# (nreg, ns, layers, columns, bands) where a team's slab and copy-ahead slots
# exceed a block's shared memory in float64 (nd = 72)
WIDE = (3, 24, 2, 13, 3)


def _check_one_launch(device, module, name, args, kw):
    """One launch of the wrapper `name` of module on args (moved to device),
    within 1e-9 per field of its plain version."""
    args = [x.to(device) for x in args]
    n = getattr(solver, name).launches
    got = getattr(module, name)(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(solver, name).launches == n + 1
    assert field_err(PLAIN[name](*args, **kw), got) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sw", "lw"])
def test_cuda_up_sweeps_global_slab(cuda_device, mode):
    """Where a slab and its copy-ahead slots exceed a block's shared memory
    (WIDE, in float64), K2 / K4 keep their slabs in a scratch of one slab per
    resident team and read their operands from device memory, still in one
    launch, and match their plain versions (1e-9 per field)."""
    nreg, ns, L, C, S = WIDE
    kw = dict(nd=nreg * ns, ns=ns, nreg=nreg)
    name = f"{mode}_up_sweep"
    c = SK.up_config(cuda_build.load(f"{mode}_sweeps"), name, nreg * ns, ns, nreg, C * S,
                     torch.float64)
    assert c["global_slab"] and c["fallback"] and c["scratch_elements"] > 0, c
    assert c["team_size"] == 32 and c["smem_per_block"] == 0, c
    _, args = _pallas_up_operands(mode, nreg, ns, L, C, S, seed=ns)
    args.append(torch.as_tensor(LegendreGauss(ns).hweight))
    _check_one_launch(cuda_device, SK if mode == "sw" else LSK, name, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sw", "lw"])
def test_cuda_down_sweeps_fallback_kernel(cuda_device, mode):
    """Where a slab and its copy-ahead slots exceed a block's shared memory
    (WIDE, in float64), K3 / K5 (on stacks from K2 / K4) keep their slabs in
    shared memory and read their operands from device memory, still in one
    launch, and match their plain versions (1e-9 per field)."""
    nreg, ns, L, C, S = WIDE
    nd = nreg * ns
    kw = dict(nd=nd, ns=ns, nreg=nreg)
    mod = SK if mode == "sw" else LSK

    def up(_, port_args, hw):
        st = getattr(mod, f"{mode}_up_sweep")(
            *(x.to(cuda_device) for x in port_args),
            torch.as_tensor(hw, device=cuda_device), **kw)[0]
        return st.cpu().numpy().transpose(2, 0, 1)

    c = SK.down_config(cuda_build.load(f"{mode}_sweeps"), f"{mode}_down_sweep", nd, ns,
                       nreg, True, True, C * S, torch.float64)
    assert c["fallback"] and not c["global_slab"] and c["scratch_elements"] == 0, c
    assert c["team_size"] == 32, c
    assert c["smem_per_block"] == c["teams_per_block"] * c["slab_bytes"], c
    _, args, _ = _pallas_down_operands(mode, nreg, ns, L, C, S, ns, up)
    _check_one_launch(cuda_device, mod, f"{mode}_down_sweep_both", args,
                      dict(kw, do_urban=True, with_profiles=True))


@pytest.mark.cuda
def test_cuda_lw_wrappers_launch_or_raise(cuda_device):
    """CUDA tensors launch the LW kernels (the counts rise) or raise: a
    misshapen operand never falls back to a plain version."""
    calls = capture(pytest.MonkeyPatch(), 2, 4, np.float32, cuda_device, C=4)
    for name, wrapper in (("lw_up_sweep", LSK.lw_up_sweep),
                          ("lw_down_sweep_both", LSK.lw_down_sweep_both),
                          ("lw_layer_factory", LK.lw_layer_factory)):
        a, k, _ = calls[name]
        n = wrapper.launches
        wrapper(*a, **k)
        assert wrapper.launches > n
        with pytest.raises(ValueError):
            wrapper(a[0][:, :-1].contiguous(), *a[1:], **k)


@pytest.mark.cuda
@pytest.mark.parametrize("nd,ndir,ts", [(2, 1, 2), (4, 2, 4), (8, 2, 8), (8, 1, 8),
                                        (12, 3, 16), (16, 4, 16), (24, 3, 32),
                                        (1, 1, 1), (2, 2, 2), (3, 3, 4), (2, 4, 2)])
def test_cuda_factory_config(cuda_device, nd, ndir, ts):
    """The launch shape of K1 (a team of the power of two >= nd lanes) and
    K1d (the dense shapes: the power of two >= nd, at most 4): whole warps
    of teams where the slabs fit, at least one block resident per SM, every
    slab in shared memory (no scratch) at these widths."""
    lib = cuda_build.load("layer_factory")
    for dtype in (torch.float32, torch.float64):
        c = LK.factory_config(lib, nd, ndir, 1000, dtype)
        assert c["team_size"] == ts, c
        assert c["threads_per_block"] == c["teams_per_block"] * ts, c
        assert c["blocks_per_sm"] >= 1 and c["registers"] > 0, c
        assert c["scratch_elements"] == 0, c
        assert c["smem_per_block"] == c["teams_per_block"] * c["slab_bytes"], c


@pytest.mark.cuda
def test_cuda_dense_factory_refuses_oversized_slab(cuda_device):
    """K1d has no global-slab kernel: where one element's slab exceeds a
    block's shared memory (nd = 1, ndir = 80, N = 82, in float64) its
    launch raises, naming the limit, and nothing runs."""
    nd, ndir = 1, 80
    assert not LK.is_structured(nd, ndir)
    ops = [x.to(cuda_device) for x in
           _random_gammas(np.random.default_rng(nd), 1, 3, nd, ndir, np.float64)]
    n = LK.layer_factory.dense_launches
    with pytest.raises(RuntimeError, match="shared memory"):
        LK.layer_factory(*ops, nd=nd, ndir=ndir)
    assert LK.layer_factory.dense_launches == n


@pytest.mark.cuda
def test_cuda_factory_global_slab(cuda_device):
    """Where one slab exceeds a block's shared memory (nd = 52 in float64)
    K1 keeps its slabs in a scratch of one slab per resident team, still in
    one launch, and matches the plain version (1e-9 per field)."""
    nd, ndir = 52, 1
    lib = cuda_build.load("layer_factory")
    ops = [x.to(cuda_device) for x in
           _random_gammas(np.random.default_rng(nd), 2, 301, nd, ndir, np.float64)]
    assert LK.factory_config(lib, nd, ndir, 602, torch.float64)["scratch_elements"] > 0
    n1 = LK.layer_factory.launches
    got = LK.layer_factory(*ops, nd=nd, ndir=ndir)
    torch.cuda.synchronize()
    assert LK.layer_factory.launches == n1 + 1
    ref = LK.layer_factory_plain(*ops, nd=nd, ndir=ndir)
    for k in ref:
        assert field_err([ref[k]], [got[k]]) <= 1e-9, k


# K1 in SW and LW mode, float32 and float64, at a width its team size
# divides (nd = 8, TS = 8) and one it does not (nd = 12, TS = 16); K1d at
# nd = ndir = 3 (TS = 4) and in LW mode at nd = 1 (TS = 1)
SANITIZED_FACTORY = """
import sys
import numpy as np
import torch
sys.path.insert(0, {tests!r})
from test_torch_kernels import _random_gammas
from spartacus_surface_tpu_torch.ops import layer_kernel as LK
dev = torch.device("cuda")
for nd, ndir in ((8, 2), (8, 1), (12, 3), (12, 1), (3, 3), (1, 1)):
    for dtype in (np.float32, np.float64):
        g0, g1, g2, g3, dz = (x.to(dev) for x in _random_gammas(
            np.random.default_rng(nd), 2, 37, nd, ndir, dtype))
        if ndir == 1:
            LK.lw_layer_factory(g1, g2, g3, dz, nd=nd)
        else:
            LK.layer_factory(g0, g1, g2, g3, dz, nd=nd, ndir=ndir)
torch.cuda.synchronize()
print("K1 launches", LK.layer_factory.launches, "K1d", LK.layer_factory.dense_launches)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("tool", ["racecheck", "synccheck"])
def test_cuda_factory_sanitizer(cuda_device, tool):
    """compute-sanitizer finds no shared-memory hazard (racecheck) and no
    invalid __syncwarp (synccheck) in small K1 and K1d launches: SW and LW
    mode, float32 and float64, K1 at nd = 8 and 12, K1d at nd = 3 (SW) and
    1 (LW).  Skips where the tool is not installed, or does not run on this
    machine."""
    exe = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(exe):
        pytest.skip("compute-sanitizer is not installed on this machine")
    import sys

    cuda_build.load("layer_factory")  # built here, not under the sanitizer
    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [exe, "--tool", tool, "--error-exitcode", "3", sys.executable, "-c",
         SANITIZED_FACTORY.format(tests=str(repo / "tests"))],
        capture_output=True, text=True, timeout=900, cwd=repo,
        env=dict(os.environ, PYTHONPATH=str(repo)))
    out = res.stdout + res.stderr
    summary = [ln for ln in out.splitlines() if "SUMMARY" in ln]
    refused = [ln for ln in out.splitlines() if "not supported" in ln]
    if refused or not summary:
        pytest.skip(f"compute-sanitizer {tool} does not run on this machine"
                    f" (exit {res.returncode}): {(refused or [out[-400:]])[0]}")
    print(summary[-1])
    assert res.returncode == 0 and "K1 launches 8 K1d 4" in out, out[-3000:]
    assert "SUMMARY: 0 hazards" in summary[-1] or "SUMMARY: 0 errors" in summary[-1], out[-3000:]
