"""Find every piece of a cell by its name: nothing here lists a cell.

``workloads/<cell>.json`` names its configuration and its traffic mix;
``configs/<config>.json`` names the driver of its engine
(``drivers/<driver>.py``); a metric is read by ``metrics/<metric>.py``
and a kernel's cost counted by ``costs/<kernel>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError("not a name: %r" % (name,))
    return name


def load_json(kind: str, name: str) -> dict:
    path = PKG / kind / (_checked(name) + ".json")
    if not path.is_file():
        raise FileNotFoundError("no %s named %r (%s)" % (kind, name, path))
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots and dashes)."""
    path = PKG / kind / (_checked(name) + ".py")
    if not path.is_file():
        return None
    mod_name = "portbench.%s._%s" % (kind, re.sub(r"[^A-Za-z0-9_]", "_", name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str) -> dict:
    """A cell's file, with its configuration and mix loaded beside it."""
    w = load_json("workloads", name)
    config = load_json("configs", w["config"])
    mix = load_json("traffic", w["traffic"])
    return {"name": name, "cell": w, "config": config, "mix": mix,
            "driver": load_module("drivers", config["driver"])}


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (those naming the cell, or, without a
    ``workloads`` key, every metric whose ``moves`` the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
