"""The comparison that decides a run's ``correct``: the outputs of calls
made in the timed window, at sampled columns, against the plain reference
(benchmark/reference) worked out again from the same inputs in float64.

Every output of run_radsurf is compared (``sw_norm_dir``, ``sw_norm_diff``,
``lw_internal``, ``lw_norm`` and ``bc_out``, each field of each), over
the sampled columns of every tile type of the cell.  Four numbers, each
the worst over its fields, in units of the field's scale max(1, max |ref|):

  max_err          the largest |program - reference| of the fluxes and
                   boundary conditions: catches a value altered where it is
                   produced and columns left out;
  rms_err          their root mean square of program - reference: steady
                   from seed to seed, and the number a lower precision moves;
  sunlit_max_err,  the same of the sunlit fractions (``*_sunlit_frac``),
  sunlit_rms_err   ratios of two direct fluxes that both vanish deep in a
                   canopy under a low sun, where float32 itself loses the
                   ratio's digits: held apart, so that their room does not
                   become the fluxes'.

A non-finite program value makes both infinite.  The SW boundary
conditions (``bc_out/sw_*``) are compared where the sun is up: upstream
skips the SW solve of a column whose sun is below the horizon
(radsurf_interface.F90:183,217,248), so its albedo there is no answer;
the port reports one solved at the clamped cosine 1e-6, where float32 is
not meant to hold (every SW flux of such a column is zero on both sides,
and compared).  The control
(``control_outputs``) is the reference itself put in the program's place
at the precision below the cell's: TF32 products for float32, float32 for
float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as R

GROUPS = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm", "bc_out")
NUMBERS = ("max_err", "rms_err", "sunlit_max_err", "sunlit_rms_err")


def _kind(number: str, field: str) -> bool:
    """Whether a field counts towards a number."""
    return number.startswith("sunlit_") == field.endswith("_sunlit_frac")


def fields(out: dict) -> dict:
    """{"group/field": tensor} of run_radsurf's outputs."""
    return {f"{g}/{k}": v for g in GROUPS if g in out for k, v in out[g].items()}


def sample_columns(rep: np.ndarray, n: int, rng: np.random.Generator,
                   floor: int = 32) -> np.ndarray:
    """About n columns drawn without replacement, each tile type's share in
    proportion to its columns but at least `floor` of it (all, where it
    has fewer); sorted."""
    rep = np.asarray(rep)
    picks = []
    for code in np.unique(rep):
        idx = np.nonzero(rep == code)[0]
        k = min(idx.size, max(floor, round(n * idx.size / rep.size)))
        picks.append(rng.choice(idx, size=k, replace=False))
    return np.sort(np.concatenate(picks))


def day_only(out: dict, cos_sza) -> dict:
    """out ({"group/field": tensor}) with the SW boundary conditions of
    the columns whose sun is below the horizon set to 0."""
    day = torch.as_tensor(np.asarray(cos_sza) > 0.0)
    res = {}
    for k, v in out.items():
        if k.startswith("bc_out/sw_"):
            v = torch.where(day.to(v.device)[:, None], v, torch.zeros((), dtype=v.dtype,
                                                                      device=v.device))
        res[k] = v
    return res


def subset(arrays: dict, cols: np.ndarray) -> dict:
    """The input arrays of the columns cols."""
    return {k: np.asarray(v)[cols] for k, v in arrays.items()}


def reference_outputs(radsurf: dict, arrays: dict, device, block: int,
                      dtype=torch.float64) -> dict:
    """{"group/field": tensor} of the reference on arrays, `block` columns
    at a time, concatenated."""
    C = np.asarray(arrays["dz"]).shape[0]
    parts = [fields(R.run_radsurf(radsurf, subset(arrays, np.arange(i, min(i + block, C))),
                                  device, dtype))
             for i in range(0, C, block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def control_outputs(radsurf: dict, arrays: dict, device, block: int, cell_dtype: str) -> dict:
    """The control: the reference at the precision below the cell's."""
    if cell_dtype == "float64":
        return reference_outputs(radsurf, arrays, device, block, torch.float32)
    with R.tf32_products():
        return reference_outputs(radsurf, arrays, device, block, torch.float32)


class Comparison:
    """The numbers of one or more compared calls, field by field."""

    def __init__(self):
        self.err = {}  # field -> [max |d|, sum d^2, count, max |ref|]

    def add(self, program: dict, reference: dict) -> None:
        """program, reference: {"group/field": tensor} of the same columns."""
        if program.keys() != reference.keys():
            raise ValueError(f"fields differ: {sorted(program.keys() ^ reference.keys())}")
        for k, ref in reference.items():
            ref = ref.to(torch.float64)
            x = program[k].to(device=ref.device, dtype=torch.float64)
            d = x - ref
            if not bool(torch.isfinite(x).all()):
                mx, sq = math.inf, math.inf
            else:
                mx = d.abs().max().item() if d.numel() else 0.0
                sq = (d * d).sum().item()
            scale = ref.abs().max().item() if ref.numel() else 0.0
            e = self.err.setdefault(k, [0.0, 0.0, 0, 0.0])
            e[0], e[1], e[2], e[3] = max(e[0], mx), e[1] + sq, e[2] + d.numel(), max(e[3], scale)

    def numbers(self) -> dict:
        """{number: (value, the field that gives it)}."""
        out = {}
        for name in NUMBERS:
            worst = (0.0, "")
            for k, (mx, sq, n, scale) in self.err.items():
                if not _kind(name, k):
                    continue
                s = max(1.0, scale)
                v = mx / s if name.endswith("max_err") else math.sqrt(sq / max(n, 1)) / s
                if v >= worst[0]:
                    worst = (v, k)
            out[name] = worst
        return out


def judge(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN or inf is not)."""
    return all(math.isfinite(numbers[k][0]) and numbers[k][0] <= limits[k] for k in limits)
