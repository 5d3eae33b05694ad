"""The port's linter and stream contract (``repro_torch.analysis``) against
the reference's (``repro.analysis``) on the same inputs.

Linter: each rule both packages share (PB001, PB002, PB004, PB005,
PB006) on its seed from ``test_analysis.SEEDS`` gives the same (rule,
line, col) from both engines; so do the pragma, attestation, baseline,
JSON and PB000 cases. PB007 has its torch meaning (an unattested
``in_bounds=True`` or constant ``sorted_within=``), and the port's default
targets lint clean with an empty baseline.

Contract: every planted fault gives the same ``invariant`` from both
``check_stream``s (indices and values from the same numpy arrays, each
package's own ``BinningDecision``); the ``fused-fits`` verdicts agree
under ``HardwareModel.tpu_v5e``; the port's own S3 decision passes under
``h100()``; a ``meta`` stream is left alone; ``reduce_stream`` under
``REPRO_PB_CHECK=1`` refuses false claims. The ``pb`` helpers:
``segment_ids_from_starts`` bit for bit, ``full_pb_scatter_add`` within
1e-6 of the largest |output| (float32 sums in another order).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import contracts as ref_contracts
from repro.analysis import lint as ref_lint
from repro.core import pb as ref_pb
from repro.core.executor import BinningDecision as RefDecision
from repro.core.plan import HardwareModel as RefHW
from repro_torch.analysis import contracts, lint
from repro_torch.analysis.contracts import ContractError
from repro_torch.core import pb
from repro_torch.core.executor import BinningDecision, PBExecutor
from repro_torch.core.plan import HardwareModel
from test_analysis import SEEDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED_RULES = ("PB001", "PB002", "PB004", "PB005", "PB006")


def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", *args],
                          cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)


def _write(tmp_path, fname, src):
    target = tmp_path / fname
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(src)
    return str(target)


def _triples(findings, rules=None):
    return sorted((f.rule, f.line, f.col) for f in findings if rules is None or f.rule in rules)


# ---------------------------------------------------------------------------
# Linter parity.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", SHARED_RULES)
def test_shared_rule_seed_same_findings(tmp_path, rule):
    path = _write(tmp_path, *SEEDS[rule])
    got = _triples(lint.lint_file(path, root=str(tmp_path)), SHARED_RULES)
    want = _triples(ref_lint.lint_file(path, root=str(tmp_path)), SHARED_RULES)
    assert got == want and rule in {r for r, _, _ in got}


@pytest.mark.parametrize("rule", ["PB003", "PB007", "PB008"])
def test_jax_only_seeds_leave_the_port_silent(tmp_path, rule):
    """The reference's PB003/PB008 seeds (JAX APIs with no twin) and its
    PB007 seed (``indices_are_sorted``) do not fire the port's rules."""
    path = _write(tmp_path, *SEEDS[rule])
    assert lint.lint_file(path, root=str(tmp_path)) == []


@pytest.mark.parametrize("src, rule", [
    ("import time\n# pb-lint: disable=PB002 -- wall-clock stamp\nstamp = time.time()\n", None),
    ("try:\n    risky()\n# pb-lint: disable=PB006 -- best effort\nexcept Exception:\n    pass\n",
     None),
    ("import time\nt0 = time.time()  # pb-lint: disable=PB006\n", "PB002"),
    ("# sorted-ok: idx comes out of a stable argsort two lines up\n"
     "out = acc.at[idx].add(val, indices_are_sorted=True)\n", None),
])
def test_suppression_pragmas_agree(tmp_path, src, rule):
    path = _write(tmp_path, "app.py", src)
    got = _triples(lint.lint_file(path, root=str(tmp_path)))
    assert got == _triples(ref_lint.lint_file(path, root=str(tmp_path)))
    assert {r for r, _, _ in got} == ({rule} if rule else set())


def test_pb000_for_a_file_that_does_not_parse(tmp_path):
    path = _write(tmp_path, "broken.py", "x = 1\ndef f(:\n")
    got = lint.lint_file(path, root=str(tmp_path))
    want = ref_lint.lint_file(path, root=str(tmp_path))
    assert [f.rule for f in got] == ["PB000"]
    assert _triples(got) == _triples(want)


def test_fingerprints_and_baseline_agree(tmp_path):
    path = _write(tmp_path, "app.py", "import time\nt0 = time.time()\n\n\nt1 = time.time()\n")
    got = lint.lint_file(path, root=str(tmp_path))
    want = ref_lint.lint_file(path, root=str(tmp_path))
    assert [f.fingerprint for f in got] == [f.fingerprint for f in want]

    def fields(fs):  # the message names each package's own Clock
        return [{k: v for k, v in f.as_dict().items() if k != "message"} for f in fs]

    assert fields(got) == fields(want)
    bl_path = str(tmp_path / "bl.json")
    lint.Baseline({got[0].fingerprint, "PB002:gone.py:x"}).save(bl_path)
    new, stale = lint.Baseline.load(bl_path).split(got)
    rnew, rstale = ref_lint.Baseline.load(bl_path).split(want)
    assert [f.line for f in new] == [f.line for f in rnew] == [5] and stale == rstale == [
        "PB002:gone.py:x"]


def test_pb007_fires_on_unattested_claims(tmp_path):
    src = textwrap.dedent("""\
        def run(ex, idx, val):
            a = ex.reduce_stream(idx, val, out_size=4, in_bounds=True)
            b = execute_reduce(idx, val, out_size=4, sorted_within=1)
            # in-bounds-ok: clamped two lines up
            c = ex.reduce_stream(idx, val, out_size=4, in_bounds=True)
            d = execute_reduce(idx, val, out_size=4, sorted_within=None, in_bounds=False)
            return a, b, c, d

        def reduce_sorted(idx, val):
            return execute_reduce(idx, val, out_size=4, sorted_within=1)
        """)
    path = _write(tmp_path, "app.py", src)
    found = [(f.rule, f.line, f.message.split(" ")[0]) for f in
             lint.lint_file(path, root=str(tmp_path))]
    assert found == [("PB007", 2, "in_bounds=True"), ("PB007", 3, "sorted_within=1")]


def test_two_attestations_on_one_line(tmp_path):
    src = ("out = execute_reduce(\n"
           "    # sorted-ok: CSR segment ids  # in-bounds-ok: each in [0, n)\n"
           "    seg, rows, out_size=n, sorted_within=1, in_bounds=True)\n")
    path = _write(tmp_path, "app.py", src)
    assert lint.lint_file(path, root=str(tmp_path)) == []


def test_cli_json_and_exit_codes(tmp_path):
    path = _write(tmp_path, "app.py", "import time\nt0 = time.time()\n")
    res = run_cli(path, "--no-baseline", "--format=json")
    assert res.returncode == 1, res.stdout + res.stderr
    blob = json.loads(res.stdout)
    (f,) = blob["findings"]
    assert (f["rule"], f["line"]) == ("PB002", 2) and f["fingerprint"].startswith("PB002:")
    assert set(blob) == {"findings", "baselined", "stale_baseline"}
    assert run_cli("--select", "PB999").returncode == 2
    assert run_cli(path, "--select", "PB006", "--no-baseline").returncode == 0
    listed = run_cli("--list-rules")
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()] == [
        "PB001", "PB002", "PB004", "PB005", "PB006", "PB007"]
    bl = str(tmp_path / "bl.json")
    assert run_cli(path, "--baseline", bl, "--write-baseline").returncode == 0
    assert run_cli(path, "--baseline", bl).returncode == 0


def test_the_linter_loads_no_torch():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import sys, repro_torch.analysis.lint, repro_torch.analysis.rules\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('torch', 'jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


def test_port_lints_clean_with_an_empty_baseline():
    with open(lint.DEFAULT_BASELINE) as f:
        assert json.load(f)["findings"] == []
    files = list(lint.iter_python_files(lint.DEFAULT_TARGETS))
    rel = {os.path.relpath(p, ROOT) for p in files}
    assert "chip_smoke.py" in rel and "src/repro_torch/core/executor.py" in rel
    assert any(r.startswith("scripts/torch_") for r in rel)
    assert lint.lint_paths() == []
    res = run_cli()
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_code_imports_neither_jax_nor_repro():
    """No module of the port, no torch script and not chip_smoke.py names
    ``jax`` or ``repro`` in an import."""
    import ast

    bad = []
    for path in lint.iter_python_files(lint.DEFAULT_TARGETS):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(path, n) for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


# ---------------------------------------------------------------------------
# Contract parity.
# ---------------------------------------------------------------------------


def _decisions(method="sort", bin_range=64, num_bins=1, source="analytic", **kw):
    return (BinningDecision(method, bin_range, num_bins, None, source, **kw),
            RefDecision(method, bin_range, num_bins, None, source, **kw))


def _both(idx, val, n, dkw=None, **kw):
    """The invariant each package's check_stream raises (None: passes)."""
    ours, theirs = _decisions(**(dkw or {}))
    hw = kw.pop("hw", None)
    out = []
    for check, d, arr, h in (
        (contracts.check_stream, ours, torch.from_numpy, hw and hw[0]),
        (ref_contracts.check_stream, theirs, jnp.asarray, hw and hw[1]),
    ):
        try:
            check(arr(idx), arr(val), n, d, hw=h, **kw)
            out.append(None)
        except (ContractError, ref_contracts.ContractError) as e:
            out.append(e.invariant)
    return out


I32, F32 = np.int32, np.float32
FAULTS = {
    "in-bounds": (np.array([0, 7, 2], I32), np.ones(3, F32), 4, None,
                  dict(in_bounds=True, level="full")),
    "in-bounds-negative": (np.array([0, -1, 2], I32), np.ones(3, F32), 4, None,
                           dict(in_bounds=True, level="full")),
    "sortedness": (np.array([3, 0, 1], I32), np.ones(3, F32), 4, None,
                   dict(sorted_within=1, level="full")),
    "sortedness-blocked": (np.array([5, 4, 3, 2], I32), np.ones(4, F32), 8, None,
                           dict(sorted_within=4, level="full")),
    "blocked-legal": (np.array([3, 2, 5, 4], I32), np.ones(4, F32), 8, None,
                      dict(sorted_within=4, level="full")),
    "index-dtype": (np.array([0.0, 1.0], F32), np.ones(2, F32), 4, None,
                    dict(in_bounds=True, level="full")),
    "cheap-skips-claims": (np.array([3, 9, 1], I32), np.ones(3, F32), 4, None,
                           dict(sorted_within=1, in_bounds=True, level="cheap")),
    "bin-range": (np.zeros(2, I32), np.ones(2, F32), 100, dict(bin_range=8, num_bins=2), {}),
    "bin-range-zero": (np.zeros(2, I32), np.ones(2, F32), 4, dict(bin_range=0), {}),
    "stream-length": (np.zeros(3, I32), np.ones(2, F32), 4, None, {}),
    "domain": (np.zeros(2, I32), np.ones(2, F32), -1, None, {}),
    "f-tile": (np.zeros(2, I32), np.ones((2, 4), F32), 4, dict(f_tile=8), {}),
    "rows-pass": (np.array([0, 1], I32), np.ones((2, 4), F32), 4, dict(f_tile=4),
                  dict(sorted_within=1, in_bounds=True, level="full")),
}
EXPECTED = {"in-bounds-negative": "in-bounds", "sortedness-blocked": "sortedness",
            "blocked-legal": None, "cheap-skips-claims": None, "bin-range-zero": "bin-range",
            "rows-pass": None}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_planted_faults_same_invariant(case):
    idx, val, n, dkw, kw = FAULTS[case]
    got, want = _both(idx, val, n, dkw, **kw)
    assert got == want == EXPECTED.get(case, case)


def test_sortedness_message_names_the_backwards_pair():
    d, _ = _decisions()
    with pytest.raises(ContractError, match=r"position 2 -> 3 goes 9 -> 4") as e:
        contracts.check_stream(torch.tensor([1, 2, 9, 4], dtype=torch.int32), torch.ones(4), 10,
                               d, sorted_within=1, level="full")
    assert "sort@r64" in str(e.value)


def _fused_grid():
    for n in (1, 1000, 4 << 20, 8 << 20, 16 << 20, 40 << 20):
        for F in (0, 1, 8):
            for dt in (F32, np.dtype("float16").type, np.int32):
                for source in ("analytic", "autotuned", "caller"):
                    for f_tile in (0, 4):
                        yield n, F, dt, source, f_tile


def test_fused_fits_verdicts_equal_under_tpu_v5e():
    hw = (HardwareModel.tpu_v5e(), RefHW.tpu_v5e())
    raised = 0
    for n, F, dt, source, f_tile in _fused_grid():
        if f_tile and not F:
            continue
        val = np.ones((3, F) if F else (3,), dt)
        dkw = dict(method="fused", bin_range=n, num_bins=1, source=source,
                   f_tile=min(f_tile, F) if F else 0)
        got, want = _both(np.zeros(3, I32), val, n, dkw, hw=hw)
        assert got == want, (n, F, dt, source, f_tile)
        raised += got == "fused-fits"
    assert raised > 10  # the grid reaches past the reference's limit


def test_port_s3_decision_passes_under_h100():
    """S3's flat fused reduce (32M nodes, 128M float32 tuples): the port's
    H100 model takes it on the two-pass kernel, past half the L2; the
    reference's clause, copied as written, would refuse it."""
    ex = PBExecutor()
    n, m = 32 << 20, 128 << 20
    d = ex.decide(n, m, torch.float32, kind="reduce", device=torch.device("cuda"))
    assert (d.method, d.source) == ("fused", "analytic")
    assert n * 4 > ex.hw.fast_levels[-1] // 2
    idx = torch.empty(m, dtype=torch.int32, device="meta")
    contracts.check_stream(idx, torch.empty(m, device="meta"), n, d, hw=ex.hw)
    with pytest.raises(ContractError) as e:  # a row stream of that size is not admitted
        contracts.check_stream(idx, torch.empty((m, 2), device="meta"), n, d, hw=ex.hw)
    assert e.value.invariant == "fused-fits"


def test_meta_streams_are_left_alone():
    d, _ = _decisions()
    idx = torch.empty(5, dtype=torch.int32, device="meta")
    contracts.check_stream(idx, torch.empty(5, device="meta"), 4, d, in_bounds=True,
                           sorted_within=1, level="full")
    contracts.check_stream(idx, torch.empty(5, device="meta"), 4, d, level="cheap")
    with pytest.raises(ContractError) as e:  # the cheap clauses still hold
        contracts.check_stream(idx, torch.empty(4, device="meta"), 4, d, level="full")
    assert e.value.invariant == "stream-length"


def test_check_level_reads_the_environment(monkeypatch):
    monkeypatch.delenv("REPRO_PB_CHECK", raising=False)
    assert contracts.check_level() == ref_contracts.check_level() == "cheap"
    monkeypatch.setenv("REPRO_PB_CHECK", "1")
    assert contracts.check_level() == ref_contracts.check_level() == "full"


def test_cache_key_completeness_flags_an_unkeyed_field():
    import dataclasses

    contracts.check_cache_key_completeness()
    Extended = dataclasses.make_dataclass(
        "Extended", [("mesh_flavor", str, dataclasses.field(default="ring"))],
        bases=(BinningDecision,), frozen=True)
    with pytest.raises(ContractError) as e:
        contracts.check_cache_key_completeness(Extended, PBExecutor)
    assert e.value.invariant == "cache-key-completeness" and "mesh_flavor" in str(e.value)


# ---------------------------------------------------------------------------
# The executor runs the contract.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("claim, idx, invariant", [
    (dict(sorted_within=1), [5, 1, 3], "sortedness"),
    (dict(in_bounds=True), [0, 9, 1], "in-bounds"),
])
@pytest.mark.parametrize("method", [None, "sort", "fused"])
def test_reduce_stream_refuses_false_claims_under_check(monkeypatch, claim, idx, invariant,
                                                         method):
    monkeypatch.setenv("REPRO_PB_CHECK", "1")
    ex = PBExecutor()
    i = torch.tensor(idx, dtype=torch.int32)
    with pytest.raises(ContractError) as e:
        ex.reduce_stream(i, torch.ones(3), out_size=8, method=method, **claim)
    assert e.value.invariant == invariant
    monkeypatch.delenv("REPRO_PB_CHECK")
    out = ex.reduce_stream(i, torch.ones(3), out_size=8, method=method, **claim)
    assert out.shape == (8,)  # the cheap level reads no data: the claim is not checked


def test_reduce_stream_true_claims_pass_and_match(monkeypatch):
    monkeypatch.setenv("REPRO_PB_CHECK", "1")
    rng = np.random.default_rng(0)
    idx = np.sort(rng.integers(0, 300, 2000)).astype(I32)
    val = rng.normal(size=(2000, 8)).astype(F32)
    got = PBExecutor().reduce_stream(torch.from_numpy(idx), torch.from_numpy(val), out_size=300,
                                     sorted_within=1, in_bounds=True)
    want = np.zeros((300, 8), F32)
    np.add.at(want, idx, val)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_shard_reduce_stream_checks_against_the_owned_range():
    """One rank of a mesh is ``reduce_stream``; a decision whose geometry
    does not cover the domain is refused before anything runs."""
    ex = PBExecutor()
    with pytest.raises(ContractError) as e:
        ex._check_contract(torch.zeros(2, dtype=torch.int32), torch.ones(2), 100,
                           _decisions(bin_range=8, num_bins=2)[0])
    assert e.value.invariant == "bin-range"


# ---------------------------------------------------------------------------
# pb.py's two helpers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counts", [[0, 3, 0, 5, 1], [4], [0, 0, 2], [1, 1, 1, 1, 1, 1]])
def test_segment_ids_from_starts_bit_for_bit(counts):
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(I32)
    m = int(starts[-1])
    got = pb.segment_ids_from_starts(torch.from_numpy(starts), m)
    want = np.asarray(ref_pb.segment_ids_from_starts(jnp.asarray(starts), m))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n, m, r", [(100, 1000, 16), (1, 5, 1), (1000, 4096, 64)])
def test_full_pb_scatter_add_matches(n, m, r):
    rng = np.random.default_rng(n + m)
    idx = rng.integers(0, n, m).astype(I32)
    val = rng.normal(size=m).astype(F32)
    nb = -(-n // r)
    got = pb.full_pb_scatter_add(torch.from_numpy(idx), torch.from_numpy(val), n, bin_range=r,
                                 num_bins=nb)
    want = np.asarray(ref_pb.full_pb_scatter_add(jnp.asarray(idx), jnp.asarray(val), n,
                                                 bin_range=r, num_bins=nb))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
