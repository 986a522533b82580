"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; its metrics are the ``end_to_end`` entries (``--trace 0``) or the
``per_layer`` entries (``--trace 1``) that list the cell, or that list no
cells.  `check_names` holds the file to the contract's rules on names,
units and sizes.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List

PACKAGE = Path(__file__).resolve().parents[1]           # portbench/
ROOT = PACKAGE.parent                                    # the checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> dict:
    return read_json(Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries a run of `cell` reports."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def check_names(bench: dict) -> List[str]:
    """Every breach of the contract's rules on keys, names, units, lines
    and counts (empty when the file keeps them)."""
    bad = []
    if set(bench) != TOP_KEYS:
        bad.append(f"top-level keys {sorted(bench)}")
    cmd = bench.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32
            and all(_line(w) for w in cmd)):
        bad.append("command")
    paths = bench.get("paths", [])
    if not (1 <= len(paths) <= 16 and all(
            PATH.match(p) and not p.startswith("/") and ".." not in p
            for p in paths)):
        bad.append("paths")
    rs = bench.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        bad.append("run_seconds")
    names = []
    for c in bench.get("configs", []):
        names.append(c.get("name"))
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config keys {sorted(c)}")
        if not (_line(c.get("source")) and _line(c.get("why"))):
            bad.append(f"config {c.get('name')}: source or why")
        if not PATH.match(c.get("file", "")) or not any(
                c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            bad.append(f"config {c.get('name')}: file")
        red = c.get("reduced", [])
        if len(red) > 16 or not all(NAME.match(k) for k in red):
            bad.append(f"config {c.get('name')}: reduced")
    for w in bench.get("workloads", []):
        names.append(w.get("name"))
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload keys {sorted(w)}")
        for k in ("config", "traffic"):
            if not NAME.match(str(w.get(k, ""))):
                bad.append(f"workload {w.get('name')}: {k}")
        if w.get("chips") not in (1, 4) or not _line(w.get("why")):
            bad.append(f"workload {w.get('name')}: chips or why")
    cells = {w.get("name") for w in bench.get("workloads", [])}
    for key, extra in (("end_to_end", {"bound"}), ("per_layer",
                                                   {"layer", "moves"})):
        for m in bench.get(key, []):
            names.append(m.get("name"))
            want = {"name", "unit", "better", "source"} | extra
            if not want <= set(m) <= want | {"workloads"}:
                bad.append(f"metric keys {sorted(m)}")
            if not UNIT.match(str(m.get("unit", ""))):
                bad.append(f"metric {m.get('name')}: unit")
            if m.get("better") not in ("lower", "higher"):
                bad.append(f"metric {m.get('name')}: better")
            if m.get("source") not in SOURCES:
                bad.append(f"metric {m.get('name')}: source")
            if not set(m.get("workloads", [])) <= cells:
                bad.append(f"metric {m.get('name')}: workloads")
            if key == "per_layer" and not _line(m.get("layer")):
                bad.append(f"metric {m.get('name')}: layer")
    if any(not NAME.match(str(n)) for n in names):
        bad.append(f"names {[n for n in names if not NAME.match(str(n))]}")
    if len(set(names)) != len(names):
        bad.append("duplicate names")
    return bad
