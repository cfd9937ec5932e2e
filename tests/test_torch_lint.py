"""The port's lint (repro_torch.analysis.lint): every rule proven live on
a seeded fixture, the framework-free rules held finding for finding to
the reference's lint, the CLI run with torch, numpy and jax unimportable,
and the port's own tree proven clean.

The counterparts of tests/test_lint.py's twelve tests come first, on a
torch fixture written under ``repro_torch/core/`` and
``repro_torch/kernels/`` (the scopes of the hot-path rules).
"""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

FIXTURE = '''\
from dataclasses import dataclass

import torch


def helper(acc=[]):                       # RPR001 (function arg)
    return acc


@dataclass
class Request:
    sampling: object = object()           # RPR001 (the PR-3 bug class)


@dataclass
class ServeConfig:
    mode: str = "a"
    n_pages: int = 8                      # RPR003 (never validated)

    def __post_init__(self):
        if self.mode != "a":
            raise ValueError(self.mode)


@dataclass
class EngineMetrics:
    n_steps: int = 0
    n_hidden: int = 0                     # RPR005 (not in summary)

    def summary(self):
        return {"n_steps": self.n_steps}


def runtime_path(xs):
    assert xs, "no tokens"                # RPR002
    out = []
    for x in xs:
        out.append(torch.as_tensor(x))    # RPR004 (scoped to core/)
    return out


def hot_step(params, tokens):
    fn = torch.compile(lambda p, t: p + t)  # RPR006 (fresh compile per call)
    total = 0.0
    for t in tokens:
        total += t.item()                 # RPR007 (sync per iteration)
    return fn(params, tokens), total


def hot_step_inline(params, tokens):
    return torch.compile(lambda p: p)(params)  # RPR006 (immediately invoked)


@dataclass
class SamplingParams:
    temperature: float = 0.0
    top_k: int = 0                        # RPR009 (never validated)

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(self.temperature)


@dataclass
class TenantTier:
    name: str = "gold"
    quota_tokens: int = 0                 # RPR009 (registry-loop misses it)

    def __post_init__(self):
        for knob in ("name",):
            if not getattr(self, knob):
                raise ValueError(knob)
'''

KERNEL_FIXTURE = '''\
import ctypes

from repro_torch.kernels import build


def launch_unchecked(x):                  # RPR008 (no contract raise)
    fn = build.kernel_fn("k", "k_f32", [ctypes.c_void_p])
    return fn(x.data_ptr())


def launch_checked(x):
    if x.dim() != 2:
        raise ValueError(f"x must be 2D, got {tuple(x.shape)}")
    fn = build.kernel_fn("k", "k_f32", [ctypes.c_void_p])
    return fn(x.data_ptr())
'''


def _write(tmp_path, sub, name, text):
    d = tmp_path.joinpath(*sub)
    d.mkdir(parents=True, exist_ok=True)
    f = d / name
    f.write_text(text)
    return f


def _write_fixture(tmp_path):
    # under a repro_torch/core/ directory so the core-scoped rules apply
    return _write(tmp_path, ("repro_torch", "core"), "seeded.py", FIXTURE)


def _write_kernel_fixture(tmp_path):
    return _write(tmp_path, ("repro_torch", "kernels"), "seeded_kernel.py",
                  KERNEL_FIXTURE)


def _codes_at(findings):
    return [(x.line, x.code) for x in findings]


# ------------------------------------------ tests/test_lint.py's twelve ----
def test_every_rule_fires_on_seeded_fixture(tmp_path):
    f = _write_fixture(tmp_path)
    kf = _write_kernel_fixture(tmp_path)
    findings = lint.lint_paths([str(f), str(kf)])
    assert {x.code for x in findings} == {
        "RPR001", "RPR002", "RPR003", "RPR004", "RPR005",
        "RPR006", "RPR007", "RPR008", "RPR009"}
    assert sum(1 for x in findings if x.code == "RPR009") == 2
    assert sum(1 for x in findings if x.code == "RPR001") == 2
    # both compile-in-hot-path shapes (in-function + immediately invoked)
    rpr006 = [x for x in findings if x.code == "RPR006"]
    assert len(rpr006) == 2
    assert any("inside hot_step()" in x.message for x in rpr006)
    assert any("one expression" in x.message for x in rpr006)
    # the contract-checked launcher is NOT flagged
    rpr008 = [x for x in findings if x.code == "RPR008"]
    assert len(rpr008) == 1 and "launch_unchecked" in rpr008[0].message


def test_select_filters_rules(tmp_path):
    f = _write_fixture(tmp_path)
    findings = lint.lint_paths([str(f)], select=["RPR002"])
    assert findings and all(x.code == "RPR002" for x in findings)


def test_scope_suppresses_core_rule_outside_core(tmp_path):
    f = _write(tmp_path, ("repro_torch", "models"), "seeded.py", FIXTURE)
    codes = {x.code for x in lint.lint_paths([str(f)])}
    assert not codes & {"RPR004", "RPR006", "RPR007"}   # layer loops are fine there
    assert "RPR002" in codes              # unscoped rules still apply
    # the reference's scope strings are not substrings of the port's
    # paths, so the torch rules fire only under the port's scopes
    ref = _write(tmp_path, ("repro", "core"), "seeded.py", FIXTURE)
    assert not {x.code for x in lint.lint_paths([str(ref)])} & {
        "RPR004", "RPR006", "RPR007"}


def test_syntax_error_is_a_finding(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def f(:\n")
    findings = lint.lint_paths([str(f)])
    assert findings and findings[0].code == "RPR000"


def test_repo_src_is_clean():
    """The port's tree, its smoke script, its tests and its examples
    (the paths a CI lint job of the port runs)."""
    paths = ([SRC / "repro_torch", ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parity.py"]
             + sorted((ROOT / "tests").glob("test_torch_*.py"))
             + sorted((ROOT / "examples").glob("torch_*.py")))
    assert lint.lint_paths([str(p) for p in paths]) == []


def test_repo_tests_and_benchmarks_are_clean():
    # the framework-free rules over every test file (bare-assert excluded
    # under tests/), as the reference's CI runs them
    assert lint.lint_paths([str(ROOT / "tests")]) == []


def test_bare_assert_excluded_in_tests(tmp_path):
    f = _write(tmp_path, ("tests",), "test_seeded.py",
               "def test_x():\n    assert 1 + 1 == 2\n")
    assert lint.lint_paths([str(f)]) == []


def test_noqa_suppression(tmp_path):
    f = tmp_path / "seeded.py"
    f.write_text(
        "def a(xs):\n"
        "    assert xs  # rpr: noqa\n"              # blanket
        "def b(xs):\n"
        "    assert xs  # rpr: noqa[RPR002]\n"      # targeted, matches
        "def c(xs):\n"
        "    assert xs  # rpr: noqa[RPR001]\n"      # targeted, no match
        "def d(xs):\n"
        "    assert xs\n")                          # unsuppressed
    findings = lint.lint_paths([str(f)])
    assert [x.line for x in findings] == [6, 8]


def test_ignore_filters_rules(tmp_path):
    f = _write_fixture(tmp_path)
    findings = lint.lint_paths([str(f)], ignore=["RPR002", "torch-in-loop"])
    codes = {x.code for x in findings}
    assert "RPR002" not in codes and "RPR004" not in codes
    assert "RPR001" in codes


def _blocked_env(tmp_path):
    """PYTHONPATH on which ``torch``, ``numpy`` and ``jax`` fail to import."""
    block = tmp_path / "blocked"
    for mod in ("torch", "numpy", "jax"):
        (block / mod).mkdir(parents=True, exist_ok=True)
        (block / mod / "__init__.py").write_text(
            f"raise ImportError('{mod} is not installed here')\n")
    return {"PYTHONPATH": f"{block}:{SRC}"}


def _cli(tmp_path, *args):
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", *args],
                         capture_output=True, text=True, env=_blocked_env(tmp_path),
                         timeout=120)
    assert "Traceback" not in out.stderr, out.stderr
    return out


def test_cli_exit_codes(tmp_path):
    """Run with torch, numpy and jax unimportable: the lint is stdlib-only,
    and so is every package on its import chain."""
    f = _write_fixture(tmp_path)
    clean = _cli(tmp_path, str(SRC / "repro_torch"))
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 finding(s)" in clean.stdout
    seeded = _cli(tmp_path, str(f))
    assert seeded.returncode == 1
    assert "RPR001" in seeded.stdout and "RPR007" in seeded.stdout


def test_cli_github_format(tmp_path):
    f = _write_fixture(tmp_path)
    out = _cli(tmp_path, str(f), "--format", "github")
    assert out.returncode == 1
    assert "::error file=" in out.stdout
    assert "title=RPR004" in out.stdout


def test_cli_ignore_flag(tmp_path):
    f = _write_fixture(tmp_path)
    codes = ",".join(r.code for r in lint.RULES)
    out = _cli(tmp_path, str(f), "--ignore", codes)
    assert out.returncode == 0, out.stdout + out.stderr


# -------------------------------------------- the torch rules, shape by shape
def _core_findings(tmp_path, body, code):
    f = _write(tmp_path, ("repro_torch", "core"), "case.py",
               "import numpy as np\nimport torch\nimport torch.nn.functional as F\n\n\n"
               + body)
    return [x.line - 5 for x in lint.lint_paths([str(f)], select=[code])]


@pytest.mark.parametrize("body,lines", [
    ("def f(xs):\n    for x in xs:\n        torch.zeros(3)\n", [3]),
    ("def f(xs):\n    while xs:\n        F.softmax(xs.pop(), -1)\n", [3]),
    ("def f(xs):\n    for x in torch.arange(4):\n        pass\n", [2]),   # header
    ("def f(xs):\n    for x in xs:\n        def g():\n            return torch.ones(1)\n", []),
    ("def f(xs):\n    torch.zeros(3)\n    return [int(x) for x in xs]\n", []),
])
def test_torch_in_loop_shapes(tmp_path, body, lines):
    assert _core_findings(tmp_path, body, "RPR004") == lines


@pytest.mark.parametrize("call,flagged", [
    ("x.item()", True), ("x.tolist()", True), ("x.cpu()", True), ("x.numpy()", True),
    ("torch.cuda.synchronize()", True), ("np.asarray(x)", True), ("np.array(x)", True),
    ("np.copy(x)", True), ("x.cpu(memory_format=None)", False), ("x.to('cpu')", False),
    ("d.item(0)", False), ("np.zeros(3)", False),
])
def test_host_sync_in_loop_shapes(tmp_path, call, flagged):
    body = f"def f(xs):\n    {call}\n    for x in xs:\n        {call}\n"
    assert _core_findings(tmp_path, body, "RPR007") == ([4] if flagged else [])


@pytest.mark.parametrize("call", ["torch.compile(g)", "torch.jit.script(g)",
                                  "torch.jit.trace(g, x)", "torch.cuda.graph(c)",
                                  "torch.cuda.CUDAGraph()"])
def test_compile_in_hot_path_shapes(tmp_path, call):
    body = (f"FN = {call}\n\n\nclass E:\n    def __init__(self):\n        self.fn = {call}\n\n"
            f"    def _build_step(self):\n        return {call}\n\n"
            f"    def step(self, x):\n        return {call}\n")
    assert _core_findings(tmp_path, body, "RPR006") == [12]


def test_compile_invoked_inline_is_flagged_anywhere(tmp_path):
    body = ("Y = torch.compile(g)(1)\n\n\nclass E:\n    def __init__(self, x):\n"
            "        self.y = torch.compile(g)(x)\n        self.fn = compile('1', 'f', 'eval')\n")
    assert _core_findings(tmp_path, body, "RPR006") == [1, 6]


def test_kernel_contract_is_scoped_to_kernels(tmp_path):
    f = _write(tmp_path, ("repro_torch", "core"), "launcher.py", KERNEL_FIXTURE)
    assert lint.lint_paths([str(f)], select=["RPR008"]) == []


# ----------------------------------- parity with the reference's lint ----
FRAMEWORK_FREE = '''\
from dataclasses import dataclass, field


def helper(acc={}, seen=set()):           # RPR001 x2
    return acc, seen


def fine(acc=None, opts=frozenset(), keep=field(default_factory=list)):
    return acc


@dataclass
class Request:
    sampling: object = dict()             # RPR001
    tags: tuple = tuple()


@dataclass
class ServeConfig:
    mode: str = "a"
    n_pages: int = 8                      # RPR003
    chunk: int = 4
    extra: int = 0                        # RPR003

    def __post_init__(self):
        for knob in ("chunk",):
            getattr(self, knob)
        if self.mode != "a":
            raise ValueError(self.mode)


@dataclass
class EngineMetrics:
    n_steps: int = 0
    n_hidden: float = 0.0                 # RPR005
    name: str = ""

    def summary(self):
        return {"n_steps": self.n_steps}


def runtime(xs):
    assert xs                             # RPR002
    assert xs  # rpr: noqa
    assert xs  # rpr: noqa[RPR002]
    assert xs  # rpr: noqa[RPR001]
    return xs


@dataclass
class SLOParams:
    ttft_target: float = 1.0              # RPR009
    tenant: str = "a"

    def __post_init__(self):
        if not self.tenant:
            raise ValueError("tenant")
'''


def test_framework_free_rules_match_the_reference(tmp_path):
    f = _write(tmp_path, ("pkg",), "free.py", FRAMEWORK_FREE)
    broken = _write(tmp_path, ("pkg",), "broken.py", "class X(:\n    pass\n")
    ours = _codes_at(lint.lint_paths([str(f), str(broken)]))
    theirs = _codes_at(ref_lint.lint_paths([str(f), str(broken)]))
    assert ours == theirs
    assert {c for _, c in ours} == {"RPR000", "RPR001", "RPR002", "RPR003", "RPR005",
                                    "RPR009"}
    assert [line for line, c in ours if c == "RPR002"] == [43, 46]   # both noqa forms


def test_rule_codes_and_names_match_the_reference():
    """Same codes in the same order; the framework-free rules keep their
    names, the torch rules name what they match."""
    ours = [(r.code, r.name) for r in lint.RULES]
    theirs = [(r.code, r.name) for r in ref_lint.RULES]
    assert [c for c, _ in ours] == [c for c, _ in theirs]
    free = {"RPR001", "RPR002", "RPR003", "RPR005", "RPR009"}
    assert [x for x in ours if x[0] in free] == [x for x in theirs if x[0] in free]
    assert {r.code: r.scope for r in lint.RULES if r.scope} == {
        "RPR004": "repro_torch/core", "RPR006": "repro_torch/core",
        "RPR007": "repro_torch/core", "RPR008": "repro_torch/kernels"}
