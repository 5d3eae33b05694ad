"""Timing rule: durations must come from a monotonic source (port of
``repro/analysis/rules/timing.py``)."""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.lint import FileContext, Finding, Rule


class PB002NonMonotonicTime(Rule):
    """No ``time.time()`` for latency/duration measurement."""

    id = "PB002"
    summary = (
        "time.time() used for timing — NTP steps move it backwards, so "
        "computed durations/latencies can go negative; use the injected "
        "Clock (serving) or time.perf_counter()"
    )
    bug = (
        "the reference's LLM Engine stamped request latencies with "
        "time.time(); fixed by the injected monotonic Clock idiom serving "
        "now uses"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "time"
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "time"
                ):
                    yield ctx.finding(
                        self.id,
                        node,
                        "time.time() — not monotonic; measure durations "
                        "with the injected Clock (repro_torch.serving."
                        "graph_frontend.Clock) or time.perf_counter()",
                    )
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time" and any(
                    a.name == "time" for a in node.names
                ):
                    yield ctx.finding(
                        self.id,
                        node,
                        "`from time import time` — the bare name hides the "
                        "non-monotonic source; import perf_counter instead",
                    )
