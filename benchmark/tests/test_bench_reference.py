"""The plain reference (benchmark/reference) against the port's scan route
in float64, on every tile type, at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import reference as R
from benchmark.check import fields

from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays


@pytest.mark.parametrize("radsurf", [
    dict(n_vegetation_region_urban=1, n_vegetation_region_forest=1, nsw=1, nlw=1),
    dict(n_vegetation_region_urban=2, n_vegetation_region_forest=2, nsw=2, nlw=3,
         n_stream_sw_urban=2, n_stream_lw_forest=6),
    dict(n_vegetation_region_urban=2, nsw=2, nlw=2, use_sw_direct_albedo=True,
         vegetation_isolation_factor_urban=0.3, do_save_flux_profile=True),
    dict(do_lw=False, nsw=2),
], ids=["nreg2", "nreg3_streams", "profiles", "sw_only"])
def test_reference_matches_the_scan_route(radsurf):
    arrays = example_arrays(C=24, L=3, S=max(radsurf.get("nsw", 1), radsurf.get("nlw", 1)),
                            dtype=np.float64, seed=11)
    S_sw, S_lw = radsurf.get("nsw", 1), radsurf.get("nlw", 1)
    for k in list(arrays):
        if k.startswith(("lw_", "ground_emis", "roof_emis", "wall_emis", "clear_air",
                         "veg_planck", "veg_air_planck")) and arrays[k].ndim > 1:
            arrays[k] = np.ascontiguousarray(arrays[k][..., :S_lw])
        elif arrays[k].ndim > 1 and arrays[k].shape[-1] > 1 and k not in (
                "dz", "veg_fraction", "veg_scale", "veg_ext", "veg_fsd",
                "veg_contact_fraction", "building_fraction", "building_scale"):
            arrays[k] = np.ascontiguousarray(arrays[k][..., :S_sw])
    arrays["cos_sza"][[2, 9]] = (-0.3, 0.01)  # a night column, a low sun
    program = fields(run_radsurf(Config(**radsurf).consolidate(), arrays, "cpu", route="scan"))
    ref = fields(R.run_radsurf(radsurf, arrays, "cpu", torch.float64))
    assert program.keys() == ref.keys()
    assert set(np.unique(arrays["i_representation"])) == set(range(6))
    for k, x in ref.items():
        torch.testing.assert_close(program[k], x, rtol=1e-12, atol=1e-12, msg=k)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import benchmark.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(__import__('pathlib').Path(__file__).parents[2]))
    loaded = eval(out.stdout)
    for name in ("spartacus_surface_tpu_torch", "spartacus_surface_tpu", "jax", "jaxlib", "flax"):
        assert name not in loaded
