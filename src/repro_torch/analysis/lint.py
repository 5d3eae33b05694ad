"""AST linter engine for the port (port of ``repro/analysis/lint.py``).

Every rule codifies one bug class the repo shipped (the ``bug`` attribute
of each rule class in ``analysis/rules/``). The engine parses each file
once with stdlib ``ast``, hands every rule a :class:`FileContext`,
filters the findings through pragma suppression and, in the CLI
(``python -m repro_torch.analysis.lint``), through a checked-in baseline
of grandfathered findings (``lint_baseline.json`` beside this module,
empty).

Suppression pragmas
-------------------
  ``# pb-lint: disable=PB001`` (or ``=PB001,PB006``) on the flagged line
      or the line directly above it suppresses those rules there; every
      disable carries a one-line justification.
  ``# sorted-ok: <why>`` / ``# in-bounds-ok: <why>`` are *attestations*:
      they satisfy PB007 (the reviewable claim the rule demands).
      ``# donate-ok:`` is still parsed, as the reference parses it.

Baselines
---------
Fingerprints hash the rule, the relative path and the stripped source
line (not the line *number*), so edits above a finding do not churn the
baseline.

Imports only the stdlib: it never loads ``torch``.
"""
from __future__ import annotations

import argparse
import ast
import glob
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# Attestation pragma kinds (PB007/PB008). The trailing ``:`` is part of
# the pragma: an attestation without a reason is not an attestation.
ATTEST_KINDS = ("sorted-ok", "in-bounds-ok", "donate-ok")

_DISABLE_RE = re.compile(r"#\s*pb-lint:\s*disable=([A-Z0-9,\s]+)")
_ATTEST_RE = re.compile(r"#\s*(" + "|".join(ATTEST_KINDS) + r"):\s*\S")


@dataclass(frozen=True)
class Finding:
    """One lint violation."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        # line-number-free: survives edits elsewhere in the file
        return f"{self.rule}:{self.path}:{self.snippet.strip()}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet.strip(),
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class FileContext:
    """One parsed file plus its pragma maps — what every rule receives."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines: List[str] = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> rules disabled there; line -> attestation kinds there
        self.disabled: Dict[int, Set[str]] = {}
        self.attests: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(text)
            if m:
                self.disabled[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
            for am in _ATTEST_RE.finditer(text):  # one line may attest both claims
                self.attests.setdefault(i, set()).add(am.group(1))
        # function spans for enclosing-function lookups (PB007/PB008)
        self.functions: List[Tuple[int, int, str]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(
                    (node.lineno, node.end_lineno or node.lineno, node.name)
                )

    # -- pragma queries ----------------------------------------------------

    def is_disabled(self, rule: str, node: ast.AST) -> bool:
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", lo) or lo
        for line in range(max(1, lo - 1), hi + 1):
            if rule in self.disabled.get(line, ()):
                return True
        return False

    def is_attested(self, kind: str, node: ast.AST) -> bool:
        """An attestation pragma adjacent to (any line of, or the line
        above/below) the flagged node."""
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", lo) or lo
        for line in range(max(1, lo - 1), hi + 2):
            if kind in self.attests.get(line, ()):
                return True
        return False

    def enclosing_function(self, node: ast.AST) -> Optional[str]:
        """Name of the innermost function whose span contains ``node``."""
        line = getattr(node, "lineno", 0)
        best: Optional[Tuple[int, int, str]] = None
        for lo, hi, name in self.functions:
            if lo <= line <= hi and (best is None or lo > best[0]):
                best = (lo, hi, name)
        return best[2] if best else None

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        return Finding(rule, self.rel, line, col, message, snippet)


class Rule:
    """Base rule: subclasses set ``id``/``summary``/``bug`` and implement
    ``check``. ``bug`` cites the shipped bug the rule encodes — the rule
    catalog in DESIGN.md §16 is generated from these attributes."""

    id: str = "PB000"
    summary: str = ""
    bug: str = ""  # the CHANGES.md incident this rule fossilizes

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Engine.
# ---------------------------------------------------------------------------

# What the default walk targets, relative to the repo root: the port's
# code, its chip check and its scripts (a target may be a glob). tests/ are
# exempt by policy (they seed violations on purpose).
DEFAULT_TARGETS = ("src/repro_torch", "chip_smoke.py", "scripts/torch_*.py")
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache"}


def repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def iter_python_files(paths: Sequence[str], root: Optional[str] = None) -> Iterator[str]:
    root = root or repo_root()
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if glob.has_magic(full):
            yield from iter_python_files(sorted(glob.glob(full)), root)
            continue
        if os.path.isfile(full):
            if full.endswith(".py"):
                yield full
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def get_rules(only: Optional[Iterable[str]] = None) -> List[Rule]:
    from repro_torch.analysis.rules import ALL_RULES

    rules = [cls() for cls in ALL_RULES]
    if only is not None:
        wanted = set(only)
        rules = [r for r in rules if r.id in wanted]
    return rules


def lint_file(
    path: str, root: Optional[str] = None, rules: Optional[List[Rule]] = None
) -> List[Finding]:
    root = root or repo_root()
    rules = rules if rules is not None else get_rules()
    rel = os.path.relpath(path, root)
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        ctx = FileContext(path, rel, source)
    except SyntaxError as e:
        return [
            Finding(
                "PB000", rel.replace(os.sep, "/"), e.lineno or 1, 0,
                f"file does not parse: {e.msg}",
            )
        ]
    out: List[Finding] = []
    for rule in rules:
        # pragma filtering happens below, so every rule gets it for free
        out.extend(rule.check(ctx))
    return [f_ for f_ in out if not _suppressed(ctx, f_)]


def _suppressed(ctx: FileContext, f: Finding) -> bool:
    for line in range(max(1, f.line - 1), f.line + 1):
        if f.rule in ctx.disabled.get(line, ()):
            return True
    return False


def lint_paths(
    paths: Optional[Sequence[str]] = None,
    root: Optional[str] = None,
    rules: Optional[List[Rule]] = None,
) -> List[Finding]:
    root = root or repo_root()
    rules = rules if rules is not None else get_rules()
    findings: List[Finding] = []
    for path in iter_python_files(paths or DEFAULT_TARGETS, root):
        findings.extend(lint_file(path, root=root, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------------
# Baseline (grandfathered findings).
# ---------------------------------------------------------------------------


@dataclass
class Baseline:
    fingerprints: Set[str] = field(default_factory=set)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.isfile(path):
            return cls()
        with open(path) as f:
            blob = json.load(f)
        return cls(set(blob.get("findings", [])))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"version": 1, "findings": sorted(self.fingerprints)}, f, indent=1
            )
            f.write("\n")

    def split(
        self, findings: Sequence[Finding]
    ) -> Tuple[List[Finding], List[str]]:
        """(new findings not in the baseline, stale baseline entries)."""
        fresh = {f.fingerprint for f in findings}
        new = [f for f in findings if f.fingerprint not in self.fingerprints]
        stale = sorted(self.fingerprints - fresh)
        return new, stale


# ---------------------------------------------------------------------------
# CLI (the options of ``scripts/pb_lint.py``).
# ---------------------------------------------------------------------------

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lint_baseline.json")


def main(argv=None) -> int:
    """Lint the port (or ``paths``). Exit 0 when every finding is in the
    baseline, 1 when new findings exist, 2 on a usage error."""
    from repro_torch.analysis.rules import ALL_RULES

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.lint",
                                 description=main.__doc__)
    ap.add_argument("paths", nargs="*",
                    help=f"files/directories to lint (default: {' '.join(DEFAULT_TARGETS)})")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", default=None, metavar="RULES",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE, metavar="FILE",
                    help="baseline file of grandfathered finding fingerprints")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline file and exit 0")
    ap.add_argument("--list-rules", action="store_true", help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    only = None
    if args.select:
        only = [r.strip() for r in args.select.split(",") if r.strip()]
        bad = sorted(set(only) - {cls.id for cls in ALL_RULES})
        if bad:
            print(f"pb_lint: unknown rule id(s): {', '.join(bad)}", file=sys.stderr)
            return 2
    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.id}  {cls.summary}")
        return 0

    root = repo_root()
    findings = lint_paths(args.paths or None, root=root, rules=get_rules(only))
    if args.write_baseline:
        bl = Baseline({f.fingerprint for f in findings})
        bl.save(args.baseline)
        print(f"pb_lint: wrote {len(bl.fingerprints)} fingerprint(s) to "
              f"{os.path.relpath(args.baseline, root)}")
        return 0
    if args.no_baseline:
        new, stale = list(findings), []
    else:
        new, stale = Baseline.load(args.baseline).split(findings)

    if args.format == "json":
        print(json.dumps({"findings": [f.as_dict() for f in new],
                          "baselined": len(findings) - len(new),
                          "stale_baseline": stale}, indent=1))
    else:
        for f in new:
            print(f.render())
        if stale:
            print(f"pb_lint: note: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (fixed findings still "
                  "grandfathered) — rerun --write-baseline to prune", file=sys.stderr)
        print(f"pb_lint: {len(new)} new finding(s), {len(findings) - len(new)} baselined",
              file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
