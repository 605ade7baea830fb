"""BENCHMARK.json and the data files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its configuration is ``configs[].file``; its mix is
``port_bench/traffic/<traffic>.json``; how the system is run on it (engine
settings, host threads, the correctness sample and limits) is
``port_bench/cells/<cell>.json``. A per-layer metric's reader is
``port_bench/metrics/<metric>.py`` and an end-to-end metric's is the same
path under its own name. Adding any of them adds files and edits none.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Manifest:
    """The parsed BENCHMARK.json of a checkout rooted at ``root``."""

    def __init__(self, root: str, raw: Optional[dict] = None):
        self.root = root
        self.raw = raw if raw is not None else _read_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> Cell:
        for w in self.raw["workloads"]:
            if w["name"] == name:
                return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]))
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.raw["configs"]:
            if c["name"] == name:
                return _read_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _read_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))

    def cell_params(self, name: str) -> dict:
        return _read_json(os.path.join(BENCH_DIR, "cells", f"{name}.json"))

    def _reports(self, metric: dict, cell: str) -> bool:
        listed = metric.get("workloads")
        return listed is None or cell in listed

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.raw["end_to_end"] if self._reports(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [
            m for m in self.raw["per_layer"]
            if m["moves"] in e2e and self._reports(m, cell)
        ]


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def problems(raw: dict, root: str) -> List[str]:
    """What in ``raw`` breaks the benchmark's contract as far as a file can
    show it (names, units, keys, that each metric's cells report the
    metric it moves, the share of four-chip cells, the files each entry
    names). Empty when sound."""
    out: List[str] = []

    def need(cond: bool, what: str) -> None:
        if not cond:
            out.append(what)

    need(set(raw) == TOP_KEYS, f"top-level keys {sorted(raw)}")
    for group, keys in (
        ("configs", CONFIG_KEYS), ("workloads", CELL_KEYS),
        ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS),
    ):
        names = [e.get("name") for e in raw.get(group, [])]
        need(len(names) == len(set(names)), f"{group}: a name appears twice")
        for e in raw.get(group, []):
            extra = set(e) - keys - ({"workloads"} if group in ("end_to_end", "per_layer") else set())
            need(not extra and keys <= set(e), f"{group} {e.get('name')}: keys {sorted(e)}")
            need(bool(NAME_RE.match(str(e.get("name", "")))), f"{group}: bad name {e.get('name')!r}")
            if "unit" in e:
                need(bool(UNIT_RE.match(e["unit"])), f"{e['name']}: bad unit {e['unit']!r}")
            if "better" in e:
                need(e["better"] in ("lower", "higher"), f"{e['name']}: better {e['better']!r}")
            for k in {"configs": ("why", "source"), "workloads": ("why",),
                      "per_layer": ("layer",)}.get(group, ()):
                v = str(e.get(k, ""))
                need(0 < len(v) <= 200 and "\n" not in v and "\t" not in v,
                     f"{e.get('name')}: {k} is not one line of 1-200 characters")
    metrics = raw.get("end_to_end", []) + raw.get("per_layer", [])
    need(len({m["name"] for m in metrics}) == len(metrics), "two metrics share a name")
    cells = {w["name"]: w for w in raw.get("workloads", [])}
    configs = {c["name"]: c for c in raw.get("configs", [])}
    for c in configs.values():
        need(os.path.isfile(os.path.join(root, c["file"])), f"config file {c['file']} missing")
        need(any(w["config"] == c["name"] for w in cells.values()), f"config {c['name']} has no cell")
        need(len(c["reduced"]) <= 16 and all(NAME_RE.match(k) for k in c["reduced"]),
             f"config {c['name']}: reduced {c['reduced']}")
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    need(len(pairs) == len(set(pairs)), "a (config, traffic) pair appears twice")
    four = sum(1 for w in cells.values() if w["chips"] == 4)
    need(four <= max(1, len(cells) // 4), f"{four} of {len(cells)} cells ask for 4 chips")
    for w in cells.values():
        need(w["chips"] in (1, 4), f"{w['name']}: chips {w['chips']}")
        need(w["config"] in configs, f"{w['name']}: unknown config {w['config']}")
        need(bool(NAME_RE.match(w["traffic"])), f"{w['name']}: bad traffic {w['traffic']!r}")
        need(os.path.isfile(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")),
             f"{w['name']}: no traffic file for {w['traffic']}")
        need(os.path.isfile(os.path.join(BENCH_DIR, "cells", f"{w['name']}.json")),
             f"{w['name']}: no cell file")
    e2e = {m["name"]: m for m in raw.get("end_to_end", [])}
    need("setup_s" in e2e, "no setup_s")
    for m in e2e.values():
        need(m["source"] in ("host_clock", "device_trace"), f"{m['name']}: source {m['source']}")
        need(0 < m["bound"] <= 0.25, f"{m['name']}: bound {m['bound']}")
        need(os.path.isfile(metric_path(m["name"])), f"{m['name']}: no reader")
    man = Manifest(root, raw)
    for m in raw.get("per_layer", []):
        need(m["moves"] in e2e, f"{m['name']}: moves unknown {m['moves']}")
        need(m["source"] in ("device_trace", "program_span", "program_counter", "host_clock"),
             f"{m['name']}: source {m['source']}")
        need(os.path.isfile(metric_path(m["name"])), f"{m['name']}: no reader")
        for cell in m.get("workloads", list(cells)):
            need(cell in cells, f"{m['name']}: unknown cell {cell}")
            if cell in cells:
                need(any(x["name"] == m["moves"] for x in man.end_to_end(cell)),
                     f"{m['name']}: cell {cell} does not report {m['moves']}")
    for w in cells.values():
        names = {m["name"] for m in man.end_to_end(w["name"])}
        need("setup_s" in names and len(names) >= 2, f"{w['name']}: end-to-end metrics {names}")
        need(len(man.per_layer(w["name"])) >= 1, f"{w['name']}: no per-layer metric")
    layers: Dict[str, str] = {}
    for m in raw.get("per_layer", []):
        layers.setdefault(m["layer"].split(":")[0], m["layer"])
        need(layers[m["layer"].split(":")[0]] == m["layer"], f"{m['name']}: layer spelled two ways")
    return out
