"""Finding model and suppression parsing shared by every prong.

Counterpart of ``ringpop_tpu/analysis/findings.py``: a finding is one
violation of a machine-checked invariant.  The AST lint reports (rule,
file, line); the graph, kernel-coverage and noninterference prongs report
(rule, entry point or registry row, location).  All of them are rendered
through the same text and json formatters, so the CLI and the tests see
one stream.

Suppressions are line-scoped comments in the linted source::

    x = int(t)  # torchgate: ignore[host-coerce]
    y = int(u)  # torchgate: ignore

``ignore[rule-a,rule-b]`` silences only the named rules on that physical
line; a bare ``ignore`` silences every rule.  A ``# torchgate: host``
marker on a ``def`` line excludes that function from tick-context
inference (see :mod:`ringpop_tpu_torch.analysis.astlint`).  Only markers
in real comment tokens count: one spelled inside a string is not a marker.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*torchgate:\s*ignore(?:\[(?P<rules>[a-z0-9_,\- ]+)\])?"
)
_HOST_RE = re.compile(r"#\s*torchgate:\s*host\b")


def _comment_lines(source: str) -> Dict[int, str]:
    """line -> comment text, from real COMMENT tokens only."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # untokenizable source: no suppressions at all (the lint reports
        # such a file as a syntax-error finding, so nothing is skipped)
        return {}
    return out


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # rule id, e.g. "host-coerce" or "host-sync"
    path: str  # repo-relative file, or "<entry:NAME>" for graph findings
    line: int  # 1-based source line; 0 when not file-anchored
    message: str
    prong: str = "ast"  # "ast" | "graph" | "kernels" | "noninterference"
    source: str = ""  # offending source line, stripped (text context)
    end_line: int = 0  # last line of the offending node (0 = same as line)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def sort_key(self) -> Tuple:
        return (self.prong, self.path, self.line, self.rule)


# suppression table: line -> None (all rules) or a set of rule ids
Suppressions = Dict[int, Optional[Set[str]]]


def parse_suppressions(source: str) -> Suppressions:
    table: Suppressions = {}
    for i, text in _comment_lines(source).items():
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = m.group("rules")
        if rules is None:
            table[i] = None
        else:
            table[i] = {r.strip() for r in rules.split(",") if r.strip()}
    return table


def host_marked_lines(source: str) -> Set[int]:
    """Lines carrying ``# torchgate: host`` (a function-level opt-out)."""
    return {
        i for i, text in _comment_lines(source).items() if _HOST_RE.search(text)
    }


def is_suppressed(f: Finding, table: Suppressions) -> bool:
    # a wrapped statement puts the comment on its last physical line;
    # honor a marker anywhere in the node's line span
    for line in range(f.line, max(f.line, f.end_line or f.line) + 1):
        if line in table:
            rules = table[line]
            if rules is None or f.rule in rules:
                return True
    return False


def render_text(findings: Iterable[Finding]) -> str:
    out: List[str] = []
    fs = sorted(findings, key=Finding.sort_key)
    for f in fs:
        loc = f"{f.path}:{f.line}" if f.line else f.path
        out.append(f"{loc}: [{f.prong}:{f.rule}] {f.message}")
        if f.source:
            out.append(f"    {f.source}")
    out.append(f"{len(fs)} finding(s)")
    return "\n".join(out)


def render_json(findings: Iterable[Finding], meta: Optional[dict] = None) -> str:
    fs = sorted(findings, key=Finding.sort_key)
    doc = {"findings": [f.as_dict() for f in fs], "count": len(fs)}
    if meta:
        # extra top-level keys (the CLI's per-prong wall clocks);
        # findings/count win on collision
        doc = {**meta, **doc}
    return json.dumps(doc, indent=2, sort_keys=True)
