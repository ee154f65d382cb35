"""Validate checkpoint manifests: schema and a full digest re-verify, over
the port's ``models/sim/checkpoint.py``.  The counterpart of the JAX
package's ``scripts/check_ckpt_manifest.py``.  The port writes the JAX
package's on-disk format, so both packages' checkpoints are checked.

Every manifest-format checkpoint directory found under the given paths
(default: ``runs_torch/``) must

- parse as a current-version manifest (``ringpop-tpu-ckpt`` v1, engine
  state format v2),
- list every array file it digests, each present at its recorded size and
  whole-file CRC32,
- hold per-array content digests that re-verify against the stored bytes
  (sharded fields per shard piece).

Usage::

    python -m ringpop_tpu_torch.tools.check_ckpt_manifest [paths...]
    python -m ringpop_tpu_torch.tools.check_ckpt_manifest --repair-scan <family-dir>

``--repair-scan`` previews a recovery: it scans a checkpoint family
(``ckpt-<tick>`` children, as ``enable_checkpoints`` lays them out)
newest first and reports which checkpoints are salvageable and which are
corrupt (with the named error), in the order ``restore_latest()`` takes.
Nothing here touches a tensor, so the tool takes no ``--device`` and
needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import recovery
from ringpop_tpu_torch.tools import RUNS_DIR

# directories never worth descending into (virtualenv-ish, caches)
_SKIP_DIRS = {".git", "__pycache__", ".jax_cache", ".pytest_cache", "node_modules"}


def find_checkpoints(paths=None) -> list:
    """Every directory holding a ``manifest.json`` under ``paths``
    (default: ``runs_torch/``).  A path that is a checkpoint directory is
    returned as itself."""
    out = []
    for root in paths or [str(RUNS_DIR)]:
        root = os.path.abspath(root)
        if os.path.isfile(os.path.join(root, ckpt.MANIFEST_NAME)):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            if ckpt.MANIFEST_NAME in filenames:
                out.append(dirpath)
    return sorted(out)


def check(paths, verbose: bool = True) -> list:
    """Deep-verify each checkpoint directory; returns the problems, one
    line each (empty: all valid)."""
    problems = []
    for path in paths:
        try:
            manifest = ckpt.verify_checkpoint(path, deep=True)
        except ckpt.CheckpointError as e:
            problems.append("%s: %s: %s" % (path, type(e).__name__, e))
            continue
        if verbose:
            states = ",".join("%s=%s" % (k, v["class"])
                              for k, v in sorted(manifest["states"].items()))
            print("ok   %s (%s; shards=%d, %d bytes)"
                  % (path, states, manifest["shards"], manifest["nbytes"]))
    return problems


def repair_scan(family_dir: str, verbose: bool = True) -> dict:
    """Newest-first salvageability report over a checkpoint family:
    ``{"valid": [(tick, path)...], "corrupt": [(tick, path, error)...],
    "resume_from": (tick, path) | None}``, ``resume_from`` being what
    ``CheckpointManager.restore_latest`` would pick."""
    entries = []
    for entry in sorted(os.listdir(family_dir)):
        m = recovery._CKPT_RE.match(entry)
        if m is not None:
            entries.append((int(m.group(1)), os.path.join(family_dir, entry)))
    valid, corrupt = [], []
    for tick, path in reversed(entries):
        try:
            ckpt.verify_checkpoint(path, deep=True)
        except ckpt.CheckpointError as e:
            corrupt.append((tick, path, "%s: %s" % (type(e).__name__, e)))
            if verbose:
                print("corrupt tick=%d %s (%s)" % (tick, path, type(e).__name__))
            continue
        valid.append((tick, path))
        if verbose:
            print("valid   tick=%d %s" % (tick, path))
    resume_from = valid[0] if valid else None
    if verbose:
        if resume_from:
            print("resume_from tick=%d %s (%d valid, %d corrupt)"
                  % (resume_from[0], resume_from[1], len(valid), len(corrupt)))
        else:
            print("resume_from NONE — clean restart (%d corrupt)" % len(corrupt))
    return {"valid": valid, "corrupt": corrupt, "resume_from": resume_from}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="check-ckpt-manifest", description=__doc__.splitlines()[0])
    p.add_argument("paths", nargs="*", help="checkpoint dirs or roots to scan")
    p.add_argument("--repair-scan", metavar="FAMILY_DIR", default=None,
                   help="salvageability report over a ckpt-<tick> family directory")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    if args.repair_scan:
        report = repair_scan(args.repair_scan, verbose=not args.quiet)
        # a family with corrupt entries still exits 0 when one survives:
        # that is the recovery contract; 1 only when none does
        return 1 if report["corrupt"] and not report["valid"] else 0

    ckpts = find_checkpoints(args.paths or None)
    if not args.quiet:
        print("checking %d checkpoint dir(s)" % len(ckpts))
    problems = check(ckpts, verbose=not args.quiet)
    for prob in problems:
        print("PROBLEM %s" % prob)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
