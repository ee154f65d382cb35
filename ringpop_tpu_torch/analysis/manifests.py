"""The committed manifests of the port's budget prongs (``scale``,
``cost``, ``donation``, ``retrace``, ``traffic``): where they live and how
each is read and written.  They sit in ``ringpop_tpu_torch/analysis/budgets/``, apart
from the JAX package's manifests at the repo root, and are regenerated by
``python -m ringpop_tpu_torch.analysis --prong <name> --write`` after an
intended change (the manifest's diff is the review)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

BUDGET_DIR = Path(__file__).resolve().parent / "budgets"


def manifest_path(name: str) -> Path:
    return BUDGET_DIR / name


def load(name: str, path: Optional[Path] = None) -> dict:
    with open(path or manifest_path(name)) as f:
        return json.load(f)


def write(name: str, doc: dict, path: Optional[Path] = None) -> Path:
    p = Path(path or manifest_path(name))
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return p


def refuse_failed(actual: dict) -> None:
    """A manifest never records a broken entry: raise on any failed one."""
    broken = {name: e["error"] for name, e in actual.items()
              if isinstance(e, dict) and "error" in e}
    broken.update({name: next(s["error"] for s in steps if "error" in s)
                   for name, steps in actual.items()
                   if isinstance(steps, list) and any("error" in s for s in steps)})
    if broken:
        raise ValueError("refusing to write a manifest with failed entries: %r" % (broken,))
