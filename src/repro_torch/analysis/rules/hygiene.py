"""Structural hygiene rules: kernel guard ordering, collection identity,
exception discipline (port of ``repro/analysis/rules/hygiene.py``). PB004
keys on ``kernels/``: in the port, the Python wrappers under
``src/repro_torch/kernels/``."""
from __future__ import annotations

import ast
import re
from typing import Iterator, List

from repro_torch.analysis.lint import FileContext, Finding, Rule


def _is_empty_guard(stmt: ast.stmt) -> bool:
    """An early-return emptiness guard: ``if <cond>: return ...`` whose
    condition compares something to 0 (``m == 0``, ``F == 0``,
    ``m == 0 or F == 0``) or negates a truthiness (``if not xs:``)."""
    if not isinstance(stmt, ast.If) or not stmt.body:
        return False
    if not isinstance(stmt.body[0], ast.Return):
        return False

    def has_zero_compare(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Compare):
                operands = [sub.left] + list(sub.comparators)
                if any(
                    isinstance(o, ast.Constant) and o.value == 0 for o in operands
                ):
                    return True
            if isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.Not):
                return True
        return False

    return has_zero_compare(stmt.test)


class PB004AssertBeforeEmptyGuard(Rule):
    """In kernels/, asserts must come after the empty-stream early return."""

    id = "PB004"
    summary = (
        "kernel assert positioned before the function's empty-stream "
        "early-return guard — an empty stream must take the guard, not "
        "trip a capacity/legality assert that is vacuous for it"
    )
    bug = (
        "the reference's cobra_bin_accumulate_rows_pallas asserted on f_tile "
        "before the F=0 early return, crashing legitimate empty-feature calls"
    )

    ONLY_DIRS = ("kernels/",)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not any(d in ctx.rel for d in self.ONLY_DIRS):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            pending: List[ast.Assert] = []
            for stmt in node.body:
                if isinstance(stmt, ast.Assert):
                    pending.append(stmt)
                elif _is_empty_guard(stmt):
                    for a in pending:
                        yield ctx.finding(
                            self.id,
                            a,
                            f"assert in {node.name}() runs before the "
                            f"empty-stream guard at line {stmt.lineno} — "
                            "move it below the guard so empty inputs "
                            "return the identity instead of asserting",
                        )
                    pending = []


class PB005EqualityRemoveOnSinkList(Rule):
    """Callback/sink list removal must be identity-based."""

    id = "PB005"
    summary = (
        "list.remove() on a callback/sink/handler list — remove() matches "
        "by ==, and sinks holding equal entries compare equal, so the "
        "WRONG one gets detached; remove by identity (is) instead"
    )
    bug = (
        "PBExecutor.remove_decision_sink used list.remove and detached the "
        "wrong sink when nested sinks held identical entries"
    )

    RECEIVER_RE = re.compile(
        r"(sink|callback|handler|listener|observer|hook)s?$", re.IGNORECASE
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr == "remove"):
                continue
            recv = f.value
            name = ""
            if isinstance(recv, ast.Attribute):
                name = recv.attr
            elif isinstance(recv, ast.Name):
                name = recv.id
            if name and self.RECEIVER_RE.search(name):
                yield ctx.finding(
                    self.id,
                    node,
                    f"{name}.remove(...) matches by equality — equal-but-"
                    "distinct registrations detach the wrong entry; scan "
                    "with `is` and delete by index (the fix in "
                    "PBExecutor.remove_decision_sink)",
                )


class PB006SilentBroadExcept(Rule):
    """No silently-swallowed broad excepts."""

    id = "PB006"
    summary = (
        "`except Exception:` (or bare except) whose body only passes/"
        "continues — failures vanish without a trace; narrow the "
        "exception, record the error, or justify with a pragma"
    )
    bug = (
        "Recurring: broad silent excepts hid autotune-cache write "
        "failures and benchmark-harness method errors until the missing "
        "data was noticed by hand (the reference's robustness fixes)"
    )

    BROAD = {"Exception", "BaseException"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            t = node.type
            broad = t is None or (isinstance(t, ast.Name) and t.id in self.BROAD)
            if not broad:
                continue
            if all(self._is_silent(s) for s in node.body):
                what = "bare except" if t is None else f"except {t.id}"
                yield ctx.finding(
                    self.id,
                    node,
                    f"{what} with a silent body — the failure leaves no "
                    "trace; catch the specific exception, log/record it, "
                    "or add `# pb-lint: disable=PB006` with a one-line "
                    "justification",
                )

    @staticmethod
    def _is_silent(stmt: ast.stmt) -> bool:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            return True
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            return True  # docstring / ellipsis
        return False
