"""The port's linter (``distributed_mnist_bnns_tpu_torch/analysis/lint``
and ``cli lint``) on the CPU: the gate of the port, as
tests/test_analysis.py is the JAX package's.

* The carried rules (JG005, JG007-JG011, JG017, JG018, ``JG000`` and the
  suppression syntax) give the JAX linter's findings — rule, line,
  column, message, suppression — on every fixture snippet of the JAX
  package's tests/test_analysis.py and tests/test_concurrency.py, read
  out of those files; and the same JSON.
* Each torch counterpart (JG001, JG002, JG012, JG014) on a positive and
  a negative snippet; JG002's include the two global-generator draws
  the port shipped (``BinarizedLM``'s and ``BnnMLP``'s ``nn.Dropout``).
* Every rule that is not applicable exits 2 with its reason.
* ``--changed-only`` in a temporary git repository, SARIF's shape.
* The port lints clean, every suppression reasoned; a mutant copy of a
  port module with an unlocked read of a guarded attribute exits 1.
"""

import ast
import json
import os
import shutil
import subprocess

import pytest

from distributed_mnist_bnns_tpu.analysis.lint import (
    format_json as jax_format_json,
)
from distributed_mnist_bnns_tpu.analysis.lint import run_source as jax_run
from distributed_mnist_bnns_tpu_torch.analysis.lint import (
    RULES,
    LintModule,
    format_json,
    run_paths,
    run_source,
)
from distributed_mnist_bnns_tpu_torch.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "distributed_mnist_bnns_tpu_torch")
CARRIED = {"JG000", "JG005", "JG007", "JG008", "JG009", "JG010", "JG011",
           "JG017", "JG018"}
COUNTERPARTS = {"JG001", "JG002", "JG012", "JG014"}
NOT_APPLICABLE = {r.id: r.reason for r in RULES.values() if r.check is None}


def active(findings, rule=None):
    return [f for f in findings
            if not f.suppressed and (rule is None or f.rule == rule)]


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------


def test_registry_decides_every_jax_rule():
    from distributed_mnist_bnns_tpu.analysis.lint import RULES as JAX_RULES

    assert list(RULES) == list(JAX_RULES)
    kinds = {r.id: r.kind for r in RULES.values()}
    assert {k for k, v in kinds.items() if v == "carried"} == CARRIED - {
        "JG000"}
    assert {k for k, v in kinds.items() if v == "counterpart"} == \
        COUNTERPARTS
    assert set(NOT_APPLICABLE) == {"JG003", "JG004", "JG006", "JG013",
                                   "JG015", "JG016"}
    assert all(len(reason) > 20 for reason in NOT_APPLICABLE.values())


# --------------------------------------------------------------------------
# carried rules: the JAX fixtures through both linters
# --------------------------------------------------------------------------


def _fixture_snippets():
    """(id, source) of every string snippet in the JAX tests of the
    carried rules: the literals bound in ``test_jg005*``,
    ``test_jg007*``..``test_jg011*``, ``test_jg017*``, ``test_jg018*``
    and ``test_suppression*``, and the ``SILENT.format(...)`` variants."""
    out = []
    prefixes = ("test_jg005", "test_jg007", "test_jg008", "test_jg009",
                "test_jg010", "test_jg011", "test_jg017", "test_jg018",
                "test_suppression")
    for name in ("test_analysis.py", "test_concurrency.py"):
        with open(os.path.join(REPO, "tests", name)) as f:
            tree = ast.parse(f.read())
        silent = None
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and getattr(node.targets[0], "id", "") == "SILENT"):
                silent = node.value.value
        for fn in tree.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name.startswith(prefixes)):
                continue
            k = 0
            for node in ast.walk(fn):
                src = None
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and "\n" in node.value):
                    src = node.value
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Attribute)
                      and getattr(node.func.value, "id", "") == "SILENT"):
                    src = silent.format(**{kw.arg: kw.value.value
                                           for kw in node.keywords})
                if src is None:
                    continue
                try:
                    ast.parse(src)
                except SyntaxError:
                    continue    # a docstring
                out.append((f"{fn.name}-{k}", src))
                k += 1
    return out


SNIPPETS = _fixture_snippets()


def _carried(findings):
    return sorted((f.rule, f.line, f.col, f.message, f.suppressed, f.reason)
                  for f in findings if f.rule in CARRIED)


def test_the_fixtures_were_found():
    names = {i.rsplit("-", 1)[0] for i, _ in SNIPPETS}
    for rule in ("jg005", "jg007", "jg008", "jg009", "jg010", "jg011",
                 "jg017", "jg018"):
        assert any(n.startswith(f"test_{rule}") for n in names), rule
    assert sum(n.startswith("test_suppression") for n in names) == 5
    assert len(SNIPPETS) >= 25
    found = {f.rule for _, src in SNIPPETS for f in jax_run(src, "lib.py")}
    assert CARRIED <= found


@pytest.mark.parametrize("path", ["lib.py", "test_lib.py"])
@pytest.mark.parametrize("sid, src", SNIPPETS, ids=[i for i, _ in SNIPPETS])
def test_carried_rules_equal_jax_on_its_fixtures(sid, src, path):
    got, want = run_source(src, path), jax_run(src, path)
    assert _carried(got) == _carried(want)


def test_json_equals_jax_on_the_fixtures():
    src = "\n".join(s for _, s in SNIPPETS if "\nclass " in s
                    or s.startswith(("import threading", "class ")))
    got = json.loads(format_json(
        [f for f in run_source(src, "lib.py") if f.rule in CARRIED]))
    want = json.loads(jax_format_json(
        [f for f in jax_run(src, "lib.py") if f.rule in CARRIED]))
    assert got == want and got["unsuppressed"] > 5


# --------------------------------------------------------------------------
# counterparts
# --------------------------------------------------------------------------

JG001_BAD = (
    "import numpy as np\n"
    "import torch\n"
    "from distributed_mnist_bnns_tpu_torch.train.capture import TrainScan\n"
    "def capture(g, step, x):\n"
    "    with torch.cuda.graph(g):\n"
    "        y = step(x)\n"
    "        n = y.item()\n"                      # 7
    "        torch.cuda.synchronize()\n"          # 8
    "    return n\n"
    "def make(body):\n"
    "    def chunk(model, opt, xs, ys, rows):\n"
    "        loss = body(model, opt, xs[0], ys[0], rows[0])\n"
    "        if float(loss) > 1:\n"               # 13
    "            print(np.asarray(loss.cpu()))\n"  # 14 (twice)
    "        return loss\n"
    "    return TrainScan(chunk)\n"
)
JG001_GOOD = (
    "import torch\n"
    "def capture(g, step, x):\n"
    "    n = x.sum().item()\n"                    # before the capture
    "    with torch.cuda.graph(g):\n"
    "        y = step(x)\n"
    "    torch.cuda.synchronize()\n"
    "    return float(y.sum()), y.tolist(), n\n"
    "def chunk(model, xs):\n"
    "    return model(xs).item()\n"               # never captured
)


def test_jg001_flags_host_syncs_in_a_capture():
    found = active(run_source(JG001_BAD, "lib.py"), "JG001")
    assert [(f.line, f.message.split()[0]) for f in found] == [
        (7, ".item()"), (8, ".synchronize()"), (13, "float()"),
        (14, "np.asarray()"), (14, ".cpu()")]
    assert not active(run_source(JG001_GOOD, "lib.py"), "JG001")


def test_jg001_captured_regions_of_the_port():
    """The port's capture entry points are the ones the rule knows: one
    ``torch.cuda.graph`` block (``train/capture.py``) and one
    ``TrainScan`` step body (``train/trainer.py::make_train_scan``)."""
    graph_blocks, scans = [], []
    for root, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                text = f.read()
            if "graph" not in text and "TrainScan" not in text:
                continue    # can hold neither entry point
            mod = LintModule(path, text)
            rel = os.path.relpath(path, PORT)
            graph_blocks += [rel for _ in mod.capture_blocks]
            scans += [(rel, fn.name) for fn in mod.captured]
    assert graph_blocks == [os.path.join("train", "capture.py")]
    assert scans == [(os.path.join("train", "trainer.py"), "chunk")]


JG002_BAD = (
    "import torch\n"
    "import torch.nn as nn\n"
    "import torch.nn.functional as F\n"
    "class TransformerBlock(nn.Module):\n"     # F6, PR 10
    "    def __init__(self, dim, dropout):\n"
    "        super().__init__()\n"
    "        self.drop = nn.Dropout(dropout)\n"   # 7
    "class BnnMLP(nn.Module):\n"                # PR 9
    "    def __init__(self, dropout_rate):\n"
    "        super().__init__()\n"
    "        self.dropout = nn.Dropout(dropout_rate)\n"   # 11
    "    def forward(self, x):\n"
    "        x = F.dropout(x, 0.5, self.training)\n"      # 13
    "        keep = torch.rand_like(x) > 0.5\n"           # 14
    "        torch.nn.init.xavier_uniform_(self.w)\n"     # 15
    "        self.b.uniform_(-1, 1)\n"                    # 16
    "        return x * keep\n"
    "def setup(seed):\n"
    "    torch.manual_seed(seed)\n"                       # 19
    "    torch.cuda.manual_seed_all(seed)\n"              # 20
)
JG002_GOOD = (
    "import random\n"
    "import torch\n"
    "from distributed_mnist_bnns_tpu_torch.models.layers import Dropout\n"
    "class Model(torch.nn.Module):\n"
    "    def __init__(self, rate, seed):\n"
    "        super().__init__()\n"
    "        self.drop = Dropout(rate)\n"          # the port's own
    "        self.gen = torch.Generator().manual_seed(seed)\n"
    "    def forward(self, x, dropout=None):\n"
    "        keep = torch.rand(x.shape, generator=self.gen) > 0.5\n"
    "        self.w.uniform_(-1, 1, generator=self.gen)\n"
    "        torch.nn.init.kaiming_normal_(self.w, generator=self.gen)\n"
    "        idx = torch.randperm(8, generator=self.gen)\n"
    "        j = random.uniform(0, 1)\n"           # the stdlib's
    "        return self.drop(x, self.gen) * keep, dropout(x), idx, j\n"
    "def test_seeded():\n"
    "    torch.manual_seed(0)\n"                   # a test function
)


def test_jg002_flags_draws_from_the_global_generator():
    found = active(run_source(JG002_BAD, "lib.py"), "JG002")
    assert [f.line for f in found] == [7, 11, 13, 14, 15, 16, 19, 20]
    assert "cannot take another" in found[0].message
    assert not active(run_source(JG002_GOOD, "lib.py"), "JG002")
    assert not active(run_source(JG002_BAD, "tests/test_lib.py"), "JG002")


JG012_BAD = (
    "import torch.distributed as dist\n"
    "def save(state, rank, group):\n"
    "    if dist.get_rank() == 0:\n"
    "        dist.barrier()\n"                          # 4
    "    if rank == 0:\n"
    "        write(state)\n"
    "    else:\n"
    "        dist.all_reduce(state, group=group)\n"     # 8
    "    if self_rank(group).local_rank:\n"
    "        helper(state)\n"                          # 10 (one hop)
    "def helper(state):\n"
    "    dist.broadcast(state, 0)\n"                   # 12
)
JG012_GOOD = (
    "import torch.distributed as dist\n"
    "def step(x, rank, world):\n"
    "    if rank == 0:\n"
    "        dist.all_reduce(x)\n"
    "    else:\n"
    "        dist.all_reduce(x)\n"
    "    if rank % 2:\n"                               # paired by design
    "        dist.send(x, rank - 1)\n"
    "    else:\n"
    "        dist.recv(x, rank + 1)\n"
    "    if world > 1:\n"                              # not the rank
    "        dist.barrier()\n"
    "    if rank == 0:\n"
    "        print(x)\n"
)


def test_jg012_flags_a_collective_on_one_side_of_a_rank_branch():
    found = active(run_source(JG012_BAD, "lib.py"), "JG012")
    assert [f.line for f in found] == [4, 8, 12]
    assert "`barrier`" in found[0].message
    assert not active(run_source(JG012_GOOD, "lib.py"), "JG012")


JG014_BAD = (
    "import torch.distributed as dist\n"
    "def step(x, y, rank):\n"
    "    if rank == 0:\n"                               # 3
    "        dist.all_reduce(x)\n"
    "        dist.broadcast(y, 0)\n"
    "    else:\n"
    "        dist.broadcast(y, 0)\n"
    "        dist.all_reduce(x)\n"
)
JG014_GOOD = (
    "import torch.distributed as dist\n"
    "def step(x, y, rank, g):\n"
    "    if rank == 0:\n"
    "        dist.all_reduce(x, group=g)\n"
    "        dist.broadcast(y, 0)\n"
    "    else:\n"
    "        dist.all_reduce(x * 2, group=g)\n"
    "        dist.broadcast(y, 0)\n"
)


def test_jg014_flags_branches_with_different_collective_sequences():
    found = active(run_source(JG014_BAD, "lib.py"), "JG014")
    assert [f.line for f in found] == [3]
    assert not active(run_source(JG014_BAD, "lib.py"), "JG012")
    assert not active(run_source(JG014_GOOD, "lib.py"), "JG014")


# --------------------------------------------------------------------------
# cli lint
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rule", sorted(NOT_APPLICABLE))
def test_cli_lint_not_applicable_rule_exits_2_with_its_reason(rule, capsys):
    rc = main(["lint", "--rule", rule, PORT])
    err = capsys.readouterr().err
    assert rc == 2
    assert rule in err and NOT_APPLICABLE[rule] in err


def test_cli_lint_unknown_rule_exits_2(capsys):
    assert main(["lint", "--rule", "JG099", PORT]) == 2
    assert "no such rule" in capsys.readouterr().err


def test_cli_lint_rule_filter_and_failure_exit(tmp_path, capsys):
    bad = tmp_path / "lib.py"
    bad.write_text(
        "import torch\nx = torch.randn(3)\n"
        "def f(g):\n"
        "    try:\n"
        "        return g()\n"
        "    except Exception:\n"
        "        pass\n"
    )
    rc = main(["lint", str(bad)])
    out = capsys.readouterr().out
    assert rc == 1 and "JG002" in out and "JG005" in out
    rc = main(["lint", "--rule", "JG005", str(bad)])
    out = capsys.readouterr().out
    assert rc == 1 and "JG002" not in out


def test_cli_lint_sarif_output(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "lib.py"
    bad.write_text(
        "import torch\n"
        "torch.manual_seed(0)\n"
        "torch.manual_seed(1)  # jg: disable=JG002 -- fixture\n"
    )
    monkeypatch.chdir(tmp_path)
    rc = main(["lint", "--format", "sarif", str(bad)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "jg-lint-torch"
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {"JG001", "JG002", "JG007", "JG011", "JG012"} <= rule_ids
    assert not rule_ids & set(NOT_APPLICABLE)
    by_level = {}
    for res in run["results"]:
        by_level.setdefault(res["level"], []).append(res)
    assert [r["ruleId"] for r in by_level["error"]] == ["JG002"]
    (sup,) = by_level["note"]
    assert sup["suppressions"][0]["justification"] == "fixture"
    loc = by_level["error"][0]["locations"][0]["physicalLocation"]
    assert loc["region"]["startLine"] == 2
    uri = loc["artifactLocation"]["uri"]
    assert uri.endswith("lib.py") and not uri.startswith("/")


def test_cli_lint_changed_only(tmp_path, capsys, monkeypatch):
    repo = tmp_path / "repo"
    repo.mkdir()
    for k in ("GIT_AUTHOR_NAME", "GIT_COMMITTER_NAME"):
        monkeypatch.setenv(k, "t")
    for k in ("GIT_AUTHOR_EMAIL", "GIT_COMMITTER_EMAIL"):
        monkeypatch.setenv(k, "t@t")

    def git(*argv):
        subprocess.run(["git", *argv], cwd=repo, check=True,
                       capture_output=True)

    bad = "import torch\nx = torch.rand(2)\n"
    git("init", "-q")
    (repo / "clean.py").write_text(bad)
    git("add", "clean.py")
    git("commit", "-qm", "seed")
    monkeypatch.chdir(repo)
    rc = main(["lint", "--changed-only"])
    out = capsys.readouterr()
    assert rc == 0 and "no changed .py files" in out.err
    (repo / "dirty.py").write_text(bad)
    rc = main(["lint", "--changed-only"])
    out = capsys.readouterr().out
    assert rc == 1 and "dirty.py" in out and "clean.py" not in out
    git("add", "dirty.py")
    git("commit", "-qm", "wip")
    base = subprocess.run(["git", "rev-parse", "--abbrev-ref", "HEAD"],
                          cwd=repo, check=True, capture_output=True,
                          text=True).stdout.strip()
    git("checkout", "-qb", "feature")
    git("checkout", "-q", base)
    (repo / "other.py").write_text(bad)
    git("add", "other.py")
    git("commit", "-qm", "landed on base after the branch point")
    git("checkout", "-q", "feature")
    (repo / "mine.py").write_text(bad)
    rc = main(["lint", "--changed-only", "--base", base])
    out = capsys.readouterr().out
    assert rc == 1 and "mine.py" in out and "other.py" not in out


# --------------------------------------------------------------------------
# the port itself is clean (the gate)
# --------------------------------------------------------------------------


def test_port_lints_clean(capsys):
    rc = main(["lint", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["unsuppressed"] == 0, [
        f for f in payload["findings"] if not f["suppressed"]]
    sup = [f for f in payload["findings"] if f["suppressed"]]
    assert sup and all(f["reason"] and not f["reason"].startswith("TODO")
                       for f in sup)
    assert all(f["path"].startswith(PORT) for f in payload["findings"])


def test_a_mutant_with_an_unlocked_guarded_read_exits_1(tmp_path, capsys):
    mutant = tmp_path / "core.py"
    shutil.copy(os.path.join(PORT, "serve", "core.py"), mutant)
    src = mutant.read_text()
    locked = ("        with self._cond:\n"
              "            return len(self._items)\n")
    assert locked in src
    mutant.write_text(src.replace(locked,
                                  "        return len(self._items)\n"))
    assert main(["lint", "--format", "json", str(mutant)]) == 1
    found = json.loads(capsys.readouterr().out)["findings"]
    assert [(f["rule"], f["suppressed"]) for f in found
            if not f["suppressed"]] == [("JG007", False)]
    assert "read of AdmissionQueue._items" in [
        f for f in found if not f["suppressed"]][0]["message"]
    assert main(["lint", os.path.join(PORT, "serve", "core.py")]) == 0
