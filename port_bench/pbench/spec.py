"""Find a cell, its configuration, its limits and the per-layer metrics
by the names in BENCHMARK.json."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent.parent        # port_bench/


class Cell(NamedTuple):
    name: str
    chips: int              # the cards the cell asks for
    workload: dict          # workloads/<cell>.json
    config_name: str
    config: dict            # configs/<config>.json
    case: object            # the module configs/<config>.py
    limits: dict            # limits/<cell>.json
    end_to_end: list        # BENCHMARK.json's metric entries
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module of the file at `path`, loaded under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name: str, root: Path, bench_dir: Path = HERE) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with every file it names
    under bench_dir."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    cfg_name = entry["config"]
    if workload.get("config", cfg_name) != cfg_name:
        raise ValueError(f"workloads/{name}.json names configuration "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{cfg_name!r}")
    config = load_json(bench_dir / "configs" / f"{cfg_name}.json")
    module = load_module(bench_dir / "configs" / f"{cfg_name}.py",
                         f"port_bench_config_{cfg_name}")
    limits = load_json(bench_dir / "limits" / f"{name}.json")
    return Cell(name, entry["chips"], workload, cfg_name, config, module,
                limits, bench["end_to_end"], bench["per_layer"])


def metric_reader(name: str, bench_dir: Path = HERE):
    """metrics/<name>.py's read(rec)."""
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       f"port_bench_metric_{name.replace('.', '_')}").read
