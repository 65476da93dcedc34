"""The port's copy of the static analyser, held against the JAX package's.

- Every per-rule fixture of ``tests/test_lint.py`` (``CASES``, imported,
  not copied) gives the same findings and suppressions, as
  ``(rule, line, col, message)``, under both packages, and the port's
  rule fires or stays clean as the case says.
- On the paths the CI gate lints (``.github/workflows/ci.yml``), the
  port's ``--pack all --json`` report equals the reference runner's byte
  for byte, against the committed baseline and without it, with equal
  exit codes; against the baseline it has no new finding.
- ``--list-rules`` under every pack, ``core`` and ``all``, an unknown
  pack (exit 2) and ``--write-baseline`` agree; the port's ``lint``
  subcommand is its runner.
"""

import contextlib
import io
import os

import pytest
from test_lint import _PRELUDE, CASES

from consensus_clustering_tpu.lint import (
    lint_file as ref_lint_file,
    select_rules as ref_select_rules,
)
from consensus_clustering_tpu.lint import runner as ref_runner
from consensus_clustering_tpu.lint.registry import RULE_PACKS as REF_PACKS
from consensus_clustering_tpu_torch.cli import main as cli_main
from consensus_clustering_tpu_torch.lint import (
    RULE_PACKS,
    lint_file,
    select_rules,
)
from consensus_clustering_tpu_torch.lint import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI_PATHS = ["consensus_clustering_tpu", "tests", "bench.py", "benchmarks",
            "examples", "scripts"]


def _call(main, argv):
    """(exit code, stdout, stderr) of a runner's ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def _keys(findings):
    return [(f.rule, f.line, f.col, f.message) for f in findings]


@pytest.mark.parametrize("rule_id,side", [
    (rule_id, side) for rule_id in sorted(CASES)
    for side in ("fires", "clean")])
def test_case_findings_equal_the_reference(rule_id, side, tmp_path):
    path = tmp_path / "snippet.py"
    path.write_text(_PRELUDE + CASES[rule_id][side])
    ours = lint_file(str(path))
    theirs = ref_lint_file(str(path))
    assert ours[2] is None and theirs[2] is None
    assert _keys(ours[0]) == _keys(theirs[0])
    assert _keys(ours[1]) == _keys(theirs[1])
    fired = rule_id in {f.rule for f in ours[0]}
    assert fired == (side == "fires"), _keys(ours[0])


@pytest.fixture(scope="module")
def ci_reports():
    """Each package's ``--pack all --json`` run on the CI paths, against
    the committed baseline and with ``--no-baseline``: one analysis per
    package (its ``lint_paths`` answered once and replayed), two reports."""
    reports = {}
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        for side, module in (("ref", ref_runner), ("port", runner)):
            analyse, memo = module.lint_paths, {}

            def once(paths, rules=None, analyse=analyse, memo=memo):
                if "result" not in memo:
                    memo["result"] = analyse(paths, rules)
                return memo["result"]

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module, "lint_paths", once)
                for mode, extra in (("baseline", []),
                                    ("no_baseline", ["--no-baseline"])):
                    reports[side, mode] = _call(
                        module.main,
                        ["--pack", "all", "--json", *extra, *CI_PATHS])
    finally:
        os.chdir(cwd)
    return reports


@pytest.mark.parametrize("mode", ["baseline", "no_baseline"])
def test_ci_report_equals_the_reference(ci_reports, mode):
    ours, theirs = ci_reports["port", mode], ci_reports["ref", mode]
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1] and ours[1].startswith("{")
    assert ours[2] == theirs[2]


def test_ci_report_has_no_new_finding(ci_reports):
    import json

    code, out, _ = ci_reports["port", "baseline"]
    summary = json.loads(out)["summary"]
    assert code == 0
    assert summary["new"] == 0 and summary["errors"] == 0
    assert summary["files"] > 0 and summary["baseline"] > 0
    assert json.loads(ci_reports["port", "no_baseline"][1])["summary"][
        "new"] == summary["baseline"]


def test_registry_and_packs_equal_the_reference():
    assert RULE_PACKS == REF_PACKS
    assert ([(r.id, r.name, r.summary) for r in select_rules(None)]
            == [(r.id, r.name, r.summary) for r in ref_select_rules(None)])


@pytest.mark.parametrize("pack", sorted(REF_PACKS) + ["core", "all", None])
def test_pack_selects_the_reference_rules(pack):
    packs = None if pack is None else [pack]
    assert ([r.id for r in select_rules(packs)]
            == [r.id for r in ref_select_rules(packs)])
    argv = ["--list-rules"] + ([] if pack is None else ["--pack", pack])
    ours, theirs = _call(runner.main, argv), _call(ref_runner.main, argv)
    assert ours == theirs and ours[0] == 0 and ours[1]


def test_unknown_pack_exits_2_as_the_reference():
    argv = ["--pack", "no-such-pack", "--list-rules"]
    ours, theirs = _call(runner.main, argv), _call(ref_runner.main, argv)
    assert ours == theirs and ours[0] == 2 and "unknown pack" in ours[2]


def _bad_tree(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for rule_id in ("JL001", "JL003", "JL004"):
        (src / f"{rule_id.lower()}.py").write_text(
            _PRELUDE + CASES[rule_id]["fires"])
    return src


def test_write_baseline_equals_the_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _bad_tree(tmp_path)
    files = {}
    for side, module in (("ref", ref_runner), ("port", runner)):
        baseline = f"{side}.json"
        code, _, err = _call(module.main, ["src", "--baseline", baseline,
                                           "--write-baseline"])
        assert code == 0, err
        files[side] = (tmp_path / baseline).read_bytes()
        assert _call(module.main, ["src", "--baseline", baseline])[0] == 0
    assert files["port"] == files["ref"] and b"JL001" in files["port"]


@pytest.mark.parametrize("extra", [[], ["--json"], ["--pack", "core"]])
def test_cli_subcommand_is_the_runner(extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _bad_tree(tmp_path)
    argv = ["src", "--baseline", "b.json", *extra]
    via_cli = _call(cli_main, ["lint", *argv])
    direct = _call(runner.main, argv)
    assert via_cli == direct and via_cli[0] == 1 and "JL001" in via_cli[1]
