"""Adjoint-based canopy-parameter retrieval on the port.

Twin of examples/retrieval.py.  Because the solver is reverse-mode
differentiable (the kernel route through solver._KernelRouteGrad: its
forward runs the kernels K1, K2 and K3, its backward the scan route),
canopy properties can be retrieved from observed fluxes by gradient
descent, which the Fortran reference cannot do.  This example retrieves the
per-column vegetation extinction coefficient of a vegetated-urban canopy
from "observed" top-of-canopy albedos and ground fluxes (generated with the
true extinction), with torch.optim.Adam on log(veg_ext), so that positivity
is automatic.

Run:  python -m spartacus_surface_tpu_torch.examples.retrieval
          [--columns 64] [--layers 4] [--steps 200] [--lr 0.02] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from ..models.solver import CanopyInputs, SolverOptions, spartacus_sw
from ..ops.legendre_gauss import LegendreGauss
from ..utils.inputs import example_inputs


def make_truth(C, L, S, rng, device):
    """The seeded float32 example canopy (utils.inputs.example_inputs, the
    JAX example's inputs draw for draw) on `device`, with veg_ext replaced
    by a truth drawn from rng; returns (inputs, truth as numpy)."""
    true_ext = rng.uniform(0.15, 0.55, (C, L)).astype(np.float32)
    fields = {**example_inputs(C=C, L=L, S=S, dtype=np.float32),
              "veg_ext": true_ext}
    return CanopyInputs(**{k: torch.as_tensor(v, device=device)
                           for k, v in fields.items()}), true_ext


def retrieve(loss_fn, x0, steps, lr, report=None):
    """Adam on loss_fn from x0: (the last iterate, the loss of each step
    before its update).  report(step, x, loss) is called after each step."""
    x = x0.clone().requires_grad_(True)
    adam = torch.optim.Adam([x], lr=lr)
    losses = []
    for i in range(steps):
        adam.zero_grad()
        loss = loss_fn(x)
        loss.backward()
        adam.step()
        losses.append(loss.item())
        if report is not None:
            report(i, x, loss)
    return x.detach(), losses


def run(argv=None) -> dict:
    """The retrieval at the command line's settings: {"final_err": mean
    |veg_ext - truth|, "losses": per step, "seconds": the loop's wall,
    ending in a synchronize}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--columns", type=int, default=64)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                   "plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")

    C, L, S = args.columns, args.layers, 1
    opt = SolverOptions(nreg=2, nstream=4, do_urban=True)
    lg = LegendreGauss(4)
    inp, true_ext = make_truth(C, L, S, np.random.default_rng(0), device)
    truth = torch.as_tensor(true_ext, device=device)

    def observe(veg_ext):
        out_dir, out_diff, bc = spartacus_sw(replace(inp, veg_ext=veg_ext),
                                             opt, lg)
        return torch.stack([bc["top_albedo_dir"][:, 0],
                            bc["top_albedo_diff"][:, 0],
                            out_dir["ground_dn"][:, 0],
                            out_dir["veg_abs"].sum(1)[:, 0],
                            out_diff["ground_dn"][:, 0]])

    with torch.no_grad():
        obs = observe(truth)
    err = lambda x: float((torch.exp(x.detach()) - truth).abs().mean())
    every = max(1, args.steps // 10)

    def report(i, x, loss):
        if i % every == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {loss.item():.3e}  "
                  f"mean |veg_ext - truth| {err(x):.4f}")

    t0 = time.perf_counter()
    x, losses = retrieve(lambda x: ((observe(torch.exp(x)) - obs) ** 2).mean(),
                         torch.log(torch.full((C, L), 0.3, device=device)),
                         args.steps, args.lr, report)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    final_err = err(x)
    print(f"final mean abs error: {final_err:.4f} (truth spans 0.15-0.55)")
    return {"final_err": final_err, "losses": losses, "seconds": seconds}


def main(argv=None) -> float:
    """Run the retrieval; returns the final mean |veg_ext - truth|."""
    return run(argv)["final_err"]


if __name__ == "__main__":
    main()
