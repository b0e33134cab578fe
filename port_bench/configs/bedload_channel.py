"""The transport-bedload channel (the sizes in bedload_channel.json): a
graded 140 x 65 x 60 mesh with a kEqn LES driven at Ubar, over a bed of
2.5 mm grains whose bottom layer is frozen.

`inputs` writes the case directory (the benchmark's frozen copy of the
case writer, `pbref.cases`) from the configuration's sizes, with the
bed's jitter drawn from the seed; `load(pkg, ...)` reads it with the
loader of `pkg`, the program's or the reference's, as the validators
load it: binned DEM, float32, capacity `capacity`, the loader's neighbor
table, semi-implicit drag. What the loader derives (the particle count,
the substeps, the table's K) must come out as the configuration states.
"""

from __future__ import annotations

import dataclasses
import importlib
import os

import torch


def inputs(spec, seed, workdir):
    """The case directory, written under `workdir`."""
    from pbref import cases
    case_dir = cases.write_channel_case(
        os.path.join(workdir, "bedload_channel"),
        counts=tuple(spec["counts"]), box=tuple(spec["box"]),
        y_grading=spec["y_grading"], layers=spec["layers"],
        d=spec["grain_diameter"], rho=spec["grain_density"],
        frozen_layers=spec["frozen_layers"], seed=seed, ubar=spec["ubar"],
        dt=spec["dt"], dem_dt=spec["dem_dt"], les_model=spec["les_model"])
    return {"case_dir": case_dir}


def load(pkg, spec, inp, device):
    """(SimConfig, FluidState, ParticleState) of `pkg`, on `device`."""
    load_case = importlib.import_module(f"{pkg}.io.case").load_case
    cfg, fluid, particles, _ = load_case(
        inp["case_dir"], backend=spec["backend"], capacity=spec["capacity"],
        dtype=getattr(torch, spec["dtype"]), device=device)
    derived = {"n_particles": int(particles.active.sum()),
               "sub_steps": cfg.cloud.sub_steps,
               "nbr_k": particles.nbr_idx.shape[0]}
    wrong = {k: v for k, v in derived.items() if v != spec[k]}
    if wrong:
        raise ValueError(f"the loaded case departs from the configuration: "
                         f"{wrong}")
    if spec["semi_implicit_drag"]:
        cfg = dataclasses.replace(cfg, cloud=dataclasses.replace(
            cfg.cloud, semi_implicit_drag=True))
    return cfg, fluid, particles


def probe_locations(spec, inp):
    """The probes of the case's own controlDict."""
    from pbref.io import foamdict
    cd = foamdict.parse_file(os.path.join(inp["case_dir"], "system",
                                          "controlDict"))
    for fn in cd.get("functions", {}).values():
        if isinstance(fn, dict) and fn.get("type") == "probes":
            return [tuple(float(x) for x in p)
                    for p in fn.get("probeLocations", [])]
    return []
