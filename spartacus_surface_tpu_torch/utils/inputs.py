"""Seeded example inputs, the same arrays as __graft_entry__'s builders, and
a seeded input file for the CLI.

``example_inputs`` follows ``__graft_entry__._example_inputs`` and
``example_arrays`` follows ``__graft_entry__._example_arrays`` draw for draw
(numpy default_rng, same seeds and order), so the tests and chip_smoke.py
give both packages identical arrays.  Both return host numpy, as does
``corner_grid``, the degenerate corner values of the JAX package's fuzz test
as one batch.
``write_example_input`` writes a NetCDF3 input file under the reference's
variable names, which both packages' ``driver.read_input`` read.
"""

from __future__ import annotations

import numpy as np

from scipy.io import netcdf_file

from .constants import StefanBoltzmann as SB


def example_inputs(C=8, L=4, S=2, dtype=np.float32, seed=0, lw=False) -> dict:
    """CanopyInputs fields ({name: numpy array}) of one column group
    (vegetated urban canopy): the shortwave fields, or with lw=True the
    longwave ones (``_example_inputs``'s lw_inp: air_ssa = 0 and uniform
    emissivities and Planck fields; no further draws)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0.1, 0.4, s).astype(dtype)
    bf = np.sort(rng.uniform(0.05, 0.3, (C, L)).astype(dtype), axis=1)[:, ::-1]
    kw = dict(
        dz=rng.uniform(3.0, 8.0, (C, L)).astype(dtype),
        cos_sza=rng.uniform(0.2, 0.9, C).astype(dtype),
        veg_fraction=f(C, L),
        veg_scale=np.full((C, L), 120.0, dtype),
        veg_ext=f(C, L),
        veg_fsd=np.full((C, L), 0.7, dtype),
        veg_contact_fraction=f(C, L),
        building_fraction=np.ascontiguousarray(bf),
        building_scale=np.full((C, L), 40.0, dtype),
        air_ext=np.full((C, L, S), 1e-5, dtype),
        air_ssa=np.full((C, L, S), 0.999, dtype),
        veg_ssa=f(C, L, S),
    )
    sw = dict(
        ground_albedo=f(C, S),
        ground_albedo_dir=f(C, S),
        roof_albedo=f(C, L, S),
        roof_albedo_dir=f(C, L, S),
        wall_albedo=f(C, L, S),
        wall_specular_frac=f(C, L, S),
    )
    if not lw:
        return {**kw, **sw}
    return {**kw, "air_ssa": np.zeros((C, L, S), dtype), **_lw_fields(C, L, S, dtype)}


def _lw_fields(C, L, S, dtype) -> dict:
    """The uniform LW facet and Planck fields of __graft_entry__'s builders."""
    full = lambda shape, v: np.full(shape, v, dtype)
    return dict(
        ground_emissivity=full((C, S), 0.95),
        ground_emission=full((C, S), SB * 0.95 * 290.0**4),
        roof_emissivity=full((C, L, S), 0.9),
        roof_emission=full((C, L, S), SB * 0.9 * 285.0**4),
        wall_emissivity=full((C, L, S), 0.9),
        wall_emission=full((C, L, S), SB * 0.9 * 288.0**4),
        clear_air_planck=full((C, L, S), SB * 283.0**4),
        veg_planck=full((C, L, S), SB * 284.0**4),
        veg_air_planck=full((C, L, S), SB * 283.0**4),
    )


def random_lw_fields(C, L, S, dtype=np.float32, seed=0) -> dict:
    """LW facet and Planck fields drawn per column, layer and band from a
    seeded generator (temperatures 270-310 K, emissivities 0.85-1), for
    checks that uniform fields cannot make (a kernel that reads the wrong
    column, layer or band).  Keys as in example_inputs(..., lw=True)."""
    rng = np.random.default_rng(seed)
    temp = lambda *s: rng.uniform(270.0, 310.0, s)
    eps = lambda *s: rng.uniform(0.85, 1.0, s)
    eg, er, ew = eps(C, S), eps(C, L, S), eps(C, L, S)
    out = dict(
        ground_emissivity=eg, ground_emission=SB * eg * temp(C, S) ** 4,
        roof_emissivity=er, roof_emission=SB * er * temp(C, L, S) ** 4,
        wall_emissivity=ew, wall_emission=SB * ew * temp(C, L, S) ** 4,
        clear_air_planck=SB * temp(C, L, S) ** 4,
        veg_planck=SB * temp(C, L, S) ** 4,
        veg_air_planck=SB * temp(C, L, S) ** 4,
    )
    return {k: v.astype(dtype) for k, v in out.items()}


def example_arrays(C=12, L=3, S=1, dtype=np.float32, seed=1,
                   i_representation=None) -> dict:
    """Dense input-arrays dict (the JAX package's read_input format).  The
    default tile mix cycles Flat, Forest, Urban, VegetatedUrban,
    SimpleUrban, InfiniteStreet; `i_representation` [C] replaces it (the
    random draws are the same either way).  Single-layer tile types get
    nlay = 1."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0.1, 0.4, s).astype(dtype)
    rep = (np.resize(np.array([0, 1, 2, 3, 4, 5], np.int64), C)
           if i_representation is None
           else np.asarray(i_representation, np.int64))
    nlay = np.where(rep >= 4, 1, L).astype(np.int64)
    return dict(
        i_representation=rep,
        nlay=nlay,
        dz=rng.uniform(3.0, 8.0, (C, L)).astype(dtype),
        cos_sza=rng.uniform(0.2, 0.9, C).astype(dtype),
        veg_fraction=f(C, L),
        veg_scale=np.full((C, L), 120.0, dtype),
        veg_ext=f(C, L),
        veg_fsd=np.full((C, L), 0.7, dtype),
        veg_contact_fraction=f(C, L),
        building_fraction=f(C, L) * 0.5,
        building_scale=np.full((C, L), 40.0, dtype),
        sw_air_ext=np.full((C, L, S), 1e-5, dtype),
        sw_air_ssa=np.full((C, L, S), 0.999, dtype),
        sw_veg_ssa=f(C, L, S),
        ground_albedo=f(C, S),
        ground_albedo_dir=f(C, S),
        roof_albedo=f(C, L, S),
        roof_albedo_dir=f(C, L, S),
        wall_albedo=f(C, L, S),
        wall_specular_frac=f(C, L, S),
        lw_air_ext=np.full((C, L, S), 1e-5, dtype),
        lw_air_ssa=np.zeros((C, L, S), dtype),
        lw_veg_ssa=f(C, L, S),
        **_lw_fields(C, L, S, dtype),
    )


# the corner values of the JAX package's fuzz test
# (tests/test_property_fuzz.py:32-37; contact and ssa: :108-109)
CORNER_FRACTIONS = (0.0, 1e-9, 1e-7, 1e-6, 2e-6, 1e-3, 0.3, 0.7, 0.97, 0.999)
CORNER_COS_SZA = (1e-7, 1e-3, 0.05, 0.5, 1.0)
CORNER_FSD = (0.0, 1e-4, 0.5, 1.0, 3.0, 10.0)
CORNER_EXT = (0.0, 1e-6, 0.1, 2.0, 20.0)
CORNER_CONTACT = (0.0, 0.5, 1.0)
CORNER_SSA = (0.0, 0.5, 0.9999)


def corner_columns(vf, bf, cos_sza, fsd, ext, contact, ssa, L=2, S=1,
                   dz=5.0) -> dict:
    """CanopyInputs fields ({name: float64 numpy}) of one column per entry
    of the per-column values, L layers of dz, S bands, with the fixed
    fields of the fuzz test's _build_inputs and _add_lw (SW and LW fields
    together; the LW solve takes air_ssa = 0)."""
    C = len(cos_sza)
    cl = lambda x: np.repeat(np.asarray(x, np.float64)[:, None], L, 1)
    full = lambda shape, v: np.full(shape, v, np.float64)
    lay, spec = (C, L), (C, L, S)
    return dict(
        dz=full(lay, dz), cos_sza=np.asarray(cos_sza, np.float64),
        veg_fraction=cl(vf), veg_scale=full(lay, 120.0), veg_ext=cl(ext),
        veg_fsd=cl(fsd), veg_contact_fraction=cl(contact),
        building_fraction=cl(bf), building_scale=full(lay, 40.0),
        air_ext=full(spec, 1e-5), air_ssa=full(spec, 0.999),
        veg_ssa=np.repeat(cl(ssa)[:, :, None], S, 2),
        ground_albedo=full((C, S), 0.2), ground_albedo_dir=full((C, S), 0.25),
        roof_albedo=full(spec, 0.3), roof_albedo_dir=full(spec, 0.3),
        wall_albedo=full(spec, 0.35), wall_specular_frac=full(spec, 0.2),
        ground_emissivity=full((C, S), 0.95),
        ground_emission=full((C, S), SB * 0.95 * 290.0**4),
        roof_emissivity=full(spec, 0.9), roof_emission=full(spec, SB * 0.9 * 285.0**4),
        wall_emissivity=full(spec, 0.9), wall_emission=full(spec, SB * 0.9 * 288.0**4),
        clear_air_planck=full(spec, SB * 283.0**4),
        veg_planck=full(spec, SB * 284.0**4),
        veg_air_planck=full(spec, SB * 283.0**4))


def corner_grid(seed=0) -> tuple:
    """The fuzz test's corner values as one deterministic batch: every
    (veg_fraction, building_fraction) pair of CORNER_FRACTIONS, scaled to a
    sum <= 0.99 as _build_inputs does, times every CORNER_COS_SZA, one
    column each (500); fsd, ext, contact and ssa drawn per column from
    default_rng(seed).  Returns (corner_columns fields, mask of the
    horizon-sun columns through thick, bright layers: cos_sza < 1e-6, ssa >
    0.99, ext >= 2)."""
    vals = []
    for vf in CORNER_FRACTIONS:
        for bf in CORNER_FRACTIONS:
            s = 0.99 / (vf + bf) if vf + bf > 0.99 else 1.0
            vals += [(vf * s, bf * s, cz) for cz in CORNER_COS_SZA]
    vf, bf, cz = map(np.array, zip(*vals))
    rng = np.random.default_rng(seed)
    draw = lambda choices: rng.choice(choices, len(cz))
    fsd, ext = draw(CORNER_FSD), draw(CORNER_EXT)
    contact, ssa = draw(CORNER_CONTACT), draw(CORNER_SSA)
    horizon = (cz < 1e-6) & (ssa > 0.99) & (ext >= 2.0)
    return corner_columns(vf, bf, cz, fsd, ext, contact, ssa), horizon


def write_example_input(path, i_representation, L=8, S=1, seed=0) -> None:
    """Write a seeded NetCDF3 (classic) input file for the CLI.

    i_representation [C]: tile code per column (0 Flat, 1 Forest, 2 Urban,
    3 VegetatedUrban, 4 SimpleUrban, 5 InfiniteStreet).  Layered tiles get
    L layers, the simple-urban ones 1, Flat 0.  Variables: those that
    driver/read_input.py reads (nlayer, height, surface_type,
    cos_solar_zenith_angle, building_* and veg_* per layer, SW albedos and
    the vegetation single-scattering albedos, LW emissivities and
    temperatures, top_flux_dn_sw, top_flux_dn_direct_sw, sky_temperature);
    with S > 1 the albedos, emissivities and ssa carry a band dimension of
    S.  Cover fractions are zero where the tile type has no buildings or no
    vegetation.  Values are drawn per column and layer from
    default_rng(seed).
    """
    rep = np.asarray(i_representation, np.int32)
    C = rep.size
    rng = np.random.default_rng(seed)
    nlay = np.select([rep == 0, rep >= 4], [0, 1], L).astype(np.int32)
    urban = np.isin(rep, [2, 3, 4, 5])[:, None]
    veg = np.isin(rep, [1, 3])[:, None]
    band = ("band",) if S > 1 else ()
    shapes = {"column": C, "layer": L, "band": S}
    # each field: (dims, low, high) of a uniform draw
    col, lay = ("column",), ("column", "layer")
    draws = {
        "cos_solar_zenith_angle": (col, 0.2, 0.9),
        "building_fraction": (lay, 0.05, 0.4),
        "building_scale": (lay, 20.0, 60.0),
        "veg_fraction": (lay, 0.1, 0.4),
        "veg_extinction": (lay, 0.1, 0.4),
        "veg_scale": (lay, 60.0, 180.0),
        "veg_fsd": (lay, 0.5, 0.9),
        "veg_contact_fraction": (lay, 0.1, 0.4),
        "ground_sw_albedo": (col + band, 0.1, 0.3),
        "roof_sw_albedo": (lay + band, 0.1, 0.4),
        "wall_sw_albedo": (lay + band, 0.1, 0.4),
        "veg_sw_ssa": (lay + band, 0.2, 0.8),
        "top_flux_dn_sw": (col + band, 200.0, 1000.0),
        "top_flux_dn_direct_sw": (col + band, 0.5, 0.9),  # x top_flux_dn_sw
        "ground_lw_emissivity": (col + band, 0.9, 1.0),
        "roof_lw_emissivity": (lay + band, 0.85, 0.95),
        "wall_lw_emissivity": (lay + band, 0.85, 0.95),
        "veg_lw_ssa": (lay + band, 0.02, 0.1),
        "ground_temperature": (col, 280.0, 300.0),
        "roof_temperature": (lay, 275.0, 305.0),
        "wall_temperature": (lay, 275.0, 305.0),
        "air_temperature": (lay, 278.0, 298.0),
        "veg_temperature": (lay, 278.0, 300.0),
        "sky_temperature": (col, 240.0, 270.0),
    }
    dz = rng.uniform(3.0, 8.0, (C, L))
    fields = {name: (dims, rng.uniform(lo, hi, [shapes[d] for d in dims]))
              for name, (dims, lo, hi) in draws.items()}
    fields["top_flux_dn_direct_sw"][1][:] *= fields["top_flux_dn_sw"][1]
    for name, mask in (("building_fraction", urban), ("veg_fraction", veg),
                       ("veg_contact_fraction", veg & urban)):
        fields[name][1][:] *= mask
    fields["height"] = (("column", "layer_interface"), np.concatenate(
        [np.zeros((C, 1)), np.cumsum(dz, 1)], 1))
    with netcdf_file(path, "w") as f:
        for dim, size in (("column", C), ("layer", L),
                          ("layer_interface", L + 1), ("band", S)):
            if dim != "band" or S > 1:
                f.createDimension(dim, size)
        for name, val in (("nlayer", nlay), ("surface_type", rep)):
            f.createVariable(name, "i", col)[:] = val
        for name, (dims, val) in fields.items():
            f.createVariable(name, "d", dims)[:] = val
