"""The port's ``check`` (``predictionio_tpu_torch/analysis``) against the
reference's ``pio check``, and the repo-wide gates on the port's tree.

* **Fixture parity.** Every rule fixture of ``tests/test_staticcheck.py``
  runs as it is, with that module's ``run_check`` routed through both
  engines: the reference's on the fixture's virtual project, the port's
  on the same sources under ``predictionio_tpu_torch/`` (the prefix
  ``predictionio_tpu/`` mapped). Both must give the same multiset of
  (rule, mapped path, line) among the new findings and among the
  baselined ones; the fixture's own assertions then run on the port's
  report. ``all_rules`` and ``env_knob_reads`` are the port's there too.
* **Repo-wide gates** on ``predictionio_tpu_torch/`` plus
  ``chip_smoke.py``, parsed once for the module: clean under
  ``conf/pio_check_baseline_torch.json`` (empty), the baseline not
  rotted, a path filter keeping the whole program, the knob docs in both
  directions, every registry entry a real port module.
* **The CLI**: ``check --json -r PIO102``, ``--list-rules``, the partial
  ``--write-baseline`` refusal, an unmatched path, and a seeded violation
  in a temporary copy of the port's tree (exit 1).
"""

import collections
import inspect
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

import test_staticcheck as ref_tests
from predictionio_tpu.analysis import engine as ref_engine
from predictionio_tpu.analysis.checkers import knobs as ref_knobs
from predictionio_tpu_torch.analysis import (
    Baseline, Project, all_rules, run_check,
)
from predictionio_tpu_torch.analysis import registry as reg
from predictionio_tpu_torch.analysis.checkers.knobs import env_knob_reads
from predictionio_tpu_torch.analysis.checkers.legacy import (
    SERIES_NOT_PORTED, registered_metric_names,
)
from predictionio_tpu_torch.cli.main import main as cli_main

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASELINE = ROOT / "conf" / "pio_check_baseline_torch.json"

RULES = ["PIO001", "PIO002", "PIO003", "PIO004", "PIO005", "PIO006",
         "PIO007", "PIO008", "PIO009", "PIO090", "PIO100", "PIO101",
         "PIO102"]


# ---------------------------------------------------------------------------
# fixture parity: the reference's rule fixtures through both engines
# ---------------------------------------------------------------------------

def _to_port(path: str) -> str:
    if path.startswith("predictionio_tpu/"):
        return "predictionio_tpu_torch/" + path[len("predictionio_tpu/"):]
    return path


def _port_project(ref_project) -> Project:
    return Project.from_sources(
        {_to_port(f.path): f.text for f in ref_project.files},
        aux=dict(ref_project._aux))


def _to_ref(path: str) -> str:
    if path.startswith("predictionio_tpu_torch/"):
        return "predictionio_tpu/" + path[len("predictionio_tpu_torch/"):]
    return path


def _baseline(cls, baseline, to):
    """``baseline`` (built from either engine's findings) with its paths
    in one package's spelling."""
    if baseline is None:
        return None
    return cls(collections.Counter(
        {(r, to(p), s): n for (r, p, s), n in baseline.entries.items()}))


def _where(findings, mapped=False):
    return collections.Counter(
        (f.rule, _to_port(f.path) if mapped else f.path, f.line)
        for f in findings)


#: the reference's tests that read its real tree or its click CLI; the
#: port's counterparts are the gates and CLI tests below
_REPO_OR_CLI = {"repo_project"}


def _fixture_tests():
    out = []
    for name, fn in vars(ref_tests).items():
        if not name.startswith("test_") or not callable(fn):
            continue
        params = set(inspect.signature(fn).parameters)
        if params & _REPO_OR_CLI or name.startswith("test_cli_"):
            continue
        out.append(name)
    return out


FIXTURE_TESTS = _fixture_tests()


def test_every_reference_fixture_is_a_case():
    """The parity cases cover the reference's fixture tests: every test
    of ``tests/test_staticcheck.py`` but its repo-wide gates and CLI."""
    assert len(FIXTURE_TESTS) >= 45
    for rule in RULES:
        n = rule[3:]
        assert any(f"pio{n}" in t for t in FIXTURE_TESTS) or rule in (
            "PIO090",), rule
    assert any("suppression" in t for t in FIXTURE_TESTS)
    assert any("baseline" in t for t in FIXTURE_TESTS)


@pytest.mark.parametrize("name", FIXTURE_TESTS)
def test_fixture_matches_reference(name, monkeypatch, tmp_path):
    compared = []

    def both_engines(project, rules=None, baseline=None, paths=None):
        def port_run():
            return run_check(_port_project(project), rules=rules,
                             baseline=_baseline(Baseline, baseline,
                                                _to_port),
                             paths=[_to_port(p) for p in paths]
                             if paths else None)

        try:
            ref = ref_engine.run_check(
                project, rules=rules,
                baseline=_baseline(ref_engine.Baseline, baseline, _to_ref),
                paths=paths)
        except ValueError:
            # an unknown rule: both engines refuse it
            with pytest.raises(ValueError):
                port_run()
            compared.append("refused")
            raise
        port = port_run()
        assert _where(port.findings) == _where(ref.findings, mapped=True)
        assert _where(port.baselined) == _where(ref.baselined,
                                                mapped=True)
        assert port.rules == ref.rules
        assert port.files_checked == ref.files_checked
        assert port.ok == ref.ok
        compared.append(port)
        return port

    def knob_reads(project):
        ref = ref_knobs.env_knob_reads(project)
        port = env_knob_reads(_port_project(project))
        assert collections.Counter(port) == collections.Counter(
            (_to_port(p), line, k) for p, line, k in ref)
        compared.append(port)
        return port

    def rules_of_both():
        assert all_rules() == ref_engine.all_rules()
        compared.append(True)
        return all_rules()

    monkeypatch.setattr(ref_tests, "run_check", both_engines)
    monkeypatch.setattr(ref_tests, "env_knob_reads", knob_reads)
    monkeypatch.setattr(ref_tests, "all_rules", rules_of_both)
    fn = getattr(ref_tests, name)
    kwargs = {"tmp_path": tmp_path} \
        if "tmp_path" in inspect.signature(fn).parameters else {}
    fn(**kwargs)
    assert compared, f"{name} ran no engine"


def test_list_rules_are_the_references_13():
    assert sorted(all_rules()) == RULES
    assert all_rules() == ref_engine.all_rules()


# ---------------------------------------------------------------------------
# the repo-wide gates on the port's tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_project():
    """The port's tree parsed once for this module's gates."""
    return Project.from_root(ROOT)


def test_scan_is_the_ports_tree_and_chip_smoke(port_project):
    paths = {f.path for f in port_project.files}
    want = {p.relative_to(ROOT).as_posix()
            for p in (ROOT / "predictionio_tpu_torch").rglob("*.py")}
    assert paths == want | {"chip_smoke.py"}
    assert not any(p.startswith("predictionio_tpu/") for p in paths)
    assert not port_project.parse_errors


@pytest.fixture(scope="module")
def port_report(port_project):
    """Every rule over the port's tree, under its baseline."""
    return run_check(port_project, baseline=Baseline.load(BASELINE))


def test_port_tree_is_clean_under_its_baseline(port_report):
    """The gate: no finding outside the baseline, which is empty: every
    finding the port's tree had was repaired or suppressed with a
    reason."""
    assert not Baseline.load(BASELINE).entries
    assert not port_report.parse_errors, port_report.parse_errors
    assert not port_report.findings, "\n" + port_report.render()
    assert port_report.rules == RULES


def test_port_baseline_has_not_rotted(port_report):
    baseline = Baseline.load(BASELINE)
    assert len(port_report.baselined) == sum(baseline.entries.values())


def test_path_filter_keeps_whole_program_context(port_project):
    report = run_check(port_project, baseline=Baseline.load(BASELINE),
                       paths=["predictionio_tpu_torch/deploy/foldin.py",
                              "predictionio_tpu_torch/deploy",
                              "predictionio_tpu_torch/obs/tsdb.py"])
    assert not report.findings, "\n" + report.render()


def test_trace_time_rules_find_nothing_on_the_port(port_project):
    """PIO001 and PIO007 match jit builders and trace-time values; the
    port compiles nothing at trace time."""
    report = run_check(port_project, rules=["PIO001", "PIO007"])
    assert report.ok and not report.findings


def test_every_suppression_carries_a_reason(port_project):
    report = run_check(port_project, rules=["PIO090"])
    assert not report.findings, "\n" + report.render()
    assert any(s for f in port_project.files for s in f.suppressions)


KNOB_TOKEN_RE = re.compile(r"\bPIO_[A-Z0-9_]+\b")


def _documented_knob_tokens():
    text = (ROOT / "README.md").read_text() + \
        (ROOT / "OBSERVABILITY.md").read_text()
    return set(KNOB_TOKEN_RE.findall(text))


def test_every_knob_the_port_reads_is_documented(port_project):
    read = {k for _, _, k in env_knob_reads(port_project)}
    tokens = _documented_knob_tokens()
    prefixes = {t for t in tokens if t.endswith("_")}
    missing = sorted(
        k for k in read
        if k not in tokens and not any(k.startswith(p) for p in prefixes))
    assert not missing, missing


def test_every_documented_knob_is_read_or_registered(port_project):
    read = {k for _, _, k in env_knob_reads(port_project)}
    table = reg.knob_table(port_project)
    known = read | set(table) | set(reg.KNOB_PREFIXES) | \
        set(reg.KNOBS_NOT_PORTED)
    prefixes = {p for p in known if p.endswith("_")}
    stale = sorted(
        t for t in _documented_knob_tokens()
        if t not in known
        and not any(t.startswith(p) for p in prefixes)
        and not (t.endswith("_") and any(k.startswith(t) for k in known)))
    assert not stale, stale


def test_not_ported_tables_are_honest(port_project):
    """A knob or series listed as not ported is not read or registered
    by the port, carries its reason, and is one the reference has."""
    read = {k for _, _, k in env_knob_reads(port_project)}
    for knob, why in reg.KNOBS_NOT_PORTED.items():
        assert knob not in read and knob not in reg.KNOB_OWNERS and why
        assert knob in ref_tests.reg.KNOB_OWNERS
    registered = registered_metric_names(port_project)
    assert not SERIES_NOT_PORTED & set(registered)
    doc = (ROOT / "OBSERVABILITY.md").read_text()
    assert all(name in doc for name in SERIES_NOT_PORTED)


def test_registry_names_real_port_modules(port_project):
    paths = {f.path for f in port_project.files}
    owners = [o for os_ in reg.KNOB_OWNERS.values() for o in os_] + \
        [o for os_ in reg.KNOB_PREFIXES.values() for o in os_]
    for owner in owners:
        assert owner == "tests/" or owner in paths, owner
    for path in (reg.SERVER_CONFIG_PATH, *reg.WIRE_MODULES,
                 *reg.LOCK_SCOPE_FILES, *reg.SEGMENT_WRITE_HELPERS):
        assert path in paths, path
    for prefix in (reg.ENGINES_PREFIX, reg.PKG_PREFIX,
                   *reg.LOCK_SCOPE_PREFIXES):
        assert any(p.startswith(prefix) for p in paths), prefix
    for path, helpers in reg.SEGMENT_WRITE_HELPERS.items():
        f = port_project.file(path)
        names = {i.name for i in port_project.functions.infos
                 if i.file is f}
        assert set(helpers) <= names, (path, helpers)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture()
def parsed_once(monkeypatch, port_project):
    """The CLI's parse of the tree replaced by the module's."""
    from predictionio_tpu_torch.analysis import model

    monkeypatch.setattr(model.Project, "from_root",
                        classmethod(lambda cls, root, paths=None:
                                    port_project))


def test_cli_check_json_one_rule(parsed_once, capsys):
    assert cli_main(["check", "--json", "-r", "PIO102"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["rules"] == ["PIO102"]
    assert set(doc) == {"version", "ok", "rules", "filesChecked",
                        "findings", "baselinedCount", "parseErrors"}


def test_cli_check_whole_tree_and_list_rules(parsed_once, capsys):
    assert cli_main(["check"]) == 0
    assert capsys.readouterr().out.strip().endswith("13 rules)")
    assert cli_main(["check", "--list-rules"]) == 0
    listed = [line.split()[0] for line in
              capsys.readouterr().out.splitlines() if line]
    assert listed == RULES


def test_cli_check_refuses_a_partial_baseline_rewrite(capsys):
    assert cli_main(["check", "-r", "PIO002", "--write-baseline"]) == 2
    assert "cannot be combined" in capsys.readouterr().out
    assert cli_main(["check", "--write-baseline",
                     "predictionio_tpu_torch/deploy"]) == 2


def test_cli_check_rejects_unmatched_and_outside_paths(parsed_once, capsys):
    assert cli_main(["check", "predictionio_tpu_torch/nope.py"]) == 2
    assert "matches no scanned file" in capsys.readouterr().out
    assert cli_main(["check", str(ROOT.parent)]) == 2
    assert "outside the project root" in capsys.readouterr().out
    assert cli_main(["check", "./predictionio_tpu_torch/deploy/foldin.py",
                     "-r", "PIO004"]) == 0
    assert cli_main(["check", "-r", "PIO999"]) == 2


def test_cli_check_fails_on_a_seeded_violation(tmp_path):
    """A copy of the port's tree with a sleep under a swap lock in a
    module of its ``deploy/``: ``check`` exits 1 and names it; without
    the module the copy exits 0."""
    shutil.copytree(ROOT / "predictionio_tpu_torch",
                    tmp_path / "predictionio_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("chip_smoke.py", "README.md", "OBSERVABILITY.md"):
        shutil.copy(ROOT / name, tmp_path / name)
    (tmp_path / "conf").mkdir()
    shutil.copy(BASELINE, tmp_path / "conf" / BASELINE.name)
    seeded = tmp_path / "predictionio_tpu_torch" / "deploy" / "seeded.py"
    seeded.write_text(
        "import threading\nimport time\n\n_swap_lock = threading.Lock()\n"
        "\n\ndef swap():\n    with _swap_lock:\n        time.sleep(1)\n")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
             "check", *args], cwd=str(tmp_path), capture_output=True,
            text=True, timeout=300)

    bad = run("--json", "-r", "PIO004")
    assert bad.returncode == 1, bad.stdout + bad.stderr
    doc = json.loads(bad.stdout)
    assert [(f["rule"], f["path"], f["line"]) for f in doc["findings"]] \
        == [("PIO004", "predictionio_tpu_torch/deploy/seeded.py", 9)]
    seeded.unlink()
    assert run("-r", "PIO004").returncode == 0
