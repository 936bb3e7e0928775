"""The benchmark's one input generator: a configuration file's tile mix,
layers and field draws, and a traffic file's precision and number of input
sets, give the seeded input sets of a cell.

Each input set is a dict of host numpy arrays in the read_input format
that ``run_radsurf`` takes (``i_representation`` and ``nlay`` [C], ``dz``
and the per-layer fields [C, L], per-band fields [C, nsw] / [C, L, nsw]
and [C, nlw] / [C, L, nlw]).  The sets of one seed share their tile
layout (so one CUDA graph key) and differ in every drawn value: the sun's
angle, temperatures and optical properties of successive timesteps.

A configuration's ``fields`` entry per array: ``dims`` (``c`` [C], ``cl``
[C, L], ``cb`` [C, bands], ``clb`` [C, L, bands]; ``band`` ``sw`` or ``lw``
picks nsw or nlw), one draw (``uniform`` [lo, hi], ``value`` v or ``choice``
[values], each entry drawn with equal odds; ``planck`` [Tlo, Thi]: sigma T^4
of a uniform T), and optionally ``descending`` (sorted to fall with height
along the layers), ``times`` (multiplied by an earlier field), ``night_share``
(that share of the entries made negative: the sun below the horizon) and
``tiles`` (the tile types on which the field is nonzero; all by default).
Layers at or above a column's ``nlay`` (Flat 0, SimpleUrban and
InfiniteStreet 1, the layered tiles ``nlay`` of the configuration) hold
zeros, the read_input padding.
"""

from __future__ import annotations

import numpy as np

SIGMA = 5.67037321e-8  # W m-2 K-4 (radtool/radiation_constants.F90)
TILE_CODES = {"Flat": 0, "Forest": 1, "Urban": 2, "VegetatedUrban": 3,
              "SimpleUrban": 4, "InfiniteStreet": 5}
DTYPES = {"float32": np.float32, "float64": np.float64}


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a seed (any whole number)."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def layout(config: dict, seed: int):
    """(i_representation [C], nlay [C]): the configuration's tile counts in
    an order drawn from the seed."""
    codes = np.concatenate([np.full(n, TILE_CODES[name], np.int64)
                            for name, n in config["tiles"].items()])
    rep = _rng(seed, 0).permutation(codes)
    nlay = np.where(rep == 0, 0, np.where(rep >= 4, 1, config["nlay"])).astype(np.int64)
    return rep, nlay


def _draw(rng, spec: dict, shape) -> np.ndarray:
    if "value" in spec:
        return np.full(shape, float(spec["value"]))
    if "choice" in spec:
        return rng.choice(np.asarray(spec["choice"], np.float64), size=shape)
    if "planck" in spec:
        return SIGMA * rng.uniform(*spec["planck"], size=shape) ** 4
    return rng.uniform(*spec["uniform"], size=shape)


def input_set(config: dict, traffic: dict, seed: int, index: int) -> dict:
    """Input set `index` of a seed."""
    rep, nlay = layout(config, seed)
    C, L = rep.size, config["nlay"]
    bands = {"sw": config["radsurf"].get("nsw", 1), "lw": config["radsurf"].get("nlw", 1)}
    rng = _rng(seed, 1, index)
    live = np.arange(L)[None, :] < nlay[:, None]  # [C, L] real layers
    out = {}
    for name, spec in config["fields"].items():
        S = bands[spec.get("band", "sw")]
        shape = {"c": (C,), "cl": (C, L), "cb": (C, S), "clb": (C, L, S)}[spec["dims"]]
        x = _draw(rng, spec, shape)
        if spec.get("descending"):
            x = -np.sort(-x, axis=1)
        if "times" in spec:
            x = x * out[spec["times"]]
        if "night_share" in spec:
            night = rng.uniform(size=shape) < spec["night_share"]
            x = np.where(night, -x, x)
        mask = np.ones(C, bool)
        if "tiles" in spec:
            mask = np.isin(rep, [TILE_CODES[t] for t in spec["tiles"]])
        mask = mask.reshape((C,) + (1,) * (x.ndim - 1))
        if spec["dims"] in ("cl", "clb"):
            mask = mask & live.reshape(live.shape + (1,) * (x.ndim - 2))
        out[name] = np.where(mask, x, 0.0)
    dtype = DTYPES[traffic["dtype"]]
    arrays = {k: np.ascontiguousarray(v, dtype) for k, v in out.items()}
    arrays.update(i_representation=rep, nlay=nlay)
    return arrays


def input_sets(config: dict, traffic: dict, seed: int) -> list:
    """The traffic's input sets of a seed, in the order the window cycles."""
    return [input_set(config, traffic, seed, i) for i in range(traffic["input_sets"])]


def columns(config: dict) -> int:
    """Columns a call."""
    return sum(config["tiles"].values())
