"""Call-site rules: executor routing and caller promises (port of
``repro/analysis/rules/calls.py``).

These rules inspect ``ast.Call`` nodes: who is called, with which
constant keyword arguments, and whether the code around the call carries
the attestation the call's semantics require.

The reference's PB003 (``jax.ops.segment_sum`` outside ``compat.py``) and
PB008 (unguarded ``donate_argnums``) key on JAX APIs that have no torch
counterpart, as ``compat.py`` has none; they have no twin here.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.lint import FileContext, Finding, Rule


def _call_name(node: ast.Call) -> str:
    """Last name segment of the called function: ``ex.reduce_stream`` ->
    ``reduce_stream``, ``reduce_stream`` -> ``reduce_stream``."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an attribute chain (``jax.ops.segment_sum``)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class PB001HardcodedMethod(Rule):
    """No hardcoded ``method="..."`` at executor decision call sites."""

    id = "PB001"
    summary = (
        "hardcoded method= at a reduce_stream/bin_stream/decide call site "
        "outside the executor — route through decide() (fused-legality, "
        "autotune, decision log all live there)"
    )
    bug = (
        "the reference's core/ call sites hardcoded method=\"fused\", "
        "bypassing the fused_fits legality check decide() enforces"
    )

    # the decision-taking entry points (PBExecutor methods); the functional
    # cores execute_reduce/execute_binning run realised decisions, not
    # choices, so they are not listed, and core/executor.py is exempt
    CALLEES = {
        "reduce_stream",
        "reduce_streams",
        "shard_reduce_stream",
        "bin_stream",
        "bin_streams",
        "scatter_add",
        "scatter_add_batched",
        "decide_or_forced",
    }
    # "auto" defers to decide(); "unbinned" is the explicit no-PB
    # baseline arm benchmarks/tests compare against
    ALLOWED = {"auto", "unbinned"}
    EXEMPT_SUFFIXES = ("core/executor.py",)
    EXEMPT_PREFIXES = ("benchmarks/", "tests/")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.rel.endswith(self.EXEMPT_SUFFIXES) or ctx.rel.startswith(
            self.EXEMPT_PREFIXES
        ):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if _call_name(node) not in self.CALLEES:
                continue
            for kw in node.keywords:
                if kw.arg != "method":
                    continue
                v = kw.value
                if (
                    isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                    and v.value not in self.ALLOWED
                ):
                    yield ctx.finding(
                        self.id,
                        kw.value,
                        f'hardcoded method="{v.value}" at a '
                        f"{_call_name(node)}() call site — pass method=None "
                        "(or \"auto\") and let decide() pick under the "
                        "legality checks, or justify with a pragma",
                    )


class PB007UnattestedSortedClaim(Rule):
    """Order and bounds promises handed to a kernel need a visible
    attestation.

    The reference's form of the bug class is ``indices_are_sorted=True``
    or ``mode="promise_in_bounds"`` handed to XLA. In the port a caller
    hands the PB reduce its claims by keyword: ``in_bounds=True`` (every
    index lies in ``[0, out_size)``) and a constant ``sorted_within=r``
    (the stream is sorted at granularity ``r``), to ``execute_reduce``,
    ``PBExecutor.reduce_stream`` and the functions that pass them on. No
    CUDA kernel of the port trusts either today: the fused, rows and
    scatter kernels drop out-of-range indices and are right for any order
    (``kernels/fused.py``, ``kernels/ops.py``), and ``execute_reduce``
    treats both as hints; the stream contract
    (``analysis/contracts.py``) holds them under ``REPRO_PB_CHECK=1``. A
    kernel that starts trusting one would write outside its output on a
    false claim, so every constant claim carries its reason now: the
    enclosing function's name carries the claim (``sorted`` /
    ``in_bounds``) or an adjacent ``# sorted-ok: <why>`` /
    ``# in-bounds-ok: <why>`` pragma states why it holds."""

    id = "PB007"
    summary = (
        "in_bounds=True or a constant sorted_within= without an "
        "attestation: the enclosing function's name must carry the claim "
        "or an adjacent # sorted-ok: / # in-bounds-ok: pragma must state "
        "why it holds"
    )
    bug = (
        "the reference's pb.bin_read_scatter_add claimed "
        "indices_are_sorted=True on a stream that was only sorted *within "
        "bins* — silently wrong results where the backend exploits the claim"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                v = kw.value
                if not isinstance(v, ast.Constant):
                    continue
                if kw.arg == "in_bounds" and v.value is True:
                    if not self._attested(ctx, v, "in_bounds", "in-bounds-ok"):
                        yield ctx.finding(
                            self.id,
                            v,
                            "in_bounds=True without attestation — add an "
                            "adjacent `# in-bounds-ok: <why>` pragma stating "
                            "which construction bounds the indices",
                        )
                elif (
                    kw.arg == "sorted_within"
                    and isinstance(v.value, int)
                    and not isinstance(v.value, bool)
                ):
                    if not self._attested(ctx, v, "sorted", "sorted-ok"):
                        yield ctx.finding(
                            self.id,
                            v,
                            f"sorted_within={v.value} without attestation — "
                            "name the function *sorted* or add an adjacent "
                            "`# sorted-ok: <why>` pragma stating where the "
                            "order comes from",
                        )

    @staticmethod
    def _attested(ctx: FileContext, node: ast.AST, in_name: str, kind: str) -> bool:
        fn = ctx.enclosing_function(node) or ""
        return in_name in fn or ctx.is_attested(kind, node)
