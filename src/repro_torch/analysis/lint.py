"""Repo-specific AST lint for the PyTorch port: static rejection of bug
classes this codebase has already shipped and fixed, and of the PyTorch
patterns that cost the card time on the serving hot path.

The counterpart of the reference's ``repro.analysis.lint``, with the
same rule codes (``--select RPR007`` means the same rule in both
packages).  RPR000-003, 005 and 009 are framework-free and behave
finding for finding as the reference's; RPR004, 006, 007 and 008 match
PyTorch in place of JAX and are scoped to the port's ``repro_torch/core``
and ``repro_torch/kernels``:

RPR001 mutable-default
    A dataclass field (or function argument) defaulted to a mutable
    literal or a bare constructor call shares ONE instance across every
    construction.  The PR-3 ``Request.sampling`` bug was exactly this —
    every request silently shared one ``SamplingParams``.  Use
    ``field(default_factory=...)``.
RPR002 bare-assert
    ``assert`` on a runtime path is stripped under ``python -O``: the
    check silently vanishes in optimized deployments.  Raise an explicit
    exception (ValueError/RuntimeError/...) instead.  (Tests are not
    linted — pytest asserts are the idiom there.)
RPR003 serveconfig-unvalidated
    Every ``ServeConfig`` field must be validated in ``__post_init__``.
    Unvalidated knobs fail deep inside the engine (or worse, don't);
    the config layer is where a bad value should die with a clear
    message.  A field counts as validated when ``__post_init__``
    mentions it — as a ``self.<field>`` access or as a string literal
    (the registry-loop idiom ``for knob in ("a", "b"): getattr(...)``).
RPR004 torch-in-loop
    A call rooted at ``torch`` (or ``F``, for ``torch.nn.functional``)
    inside a Python-level ``for``/``while`` on the host path launches
    at least one kernel per iteration: each launch costs the host
    several microseconds and the card a kernel too small to fill it,
    and the engine's host already leaves the card idle most of a step.
    The engine's per-token loops must stay in numpy / plain Python and
    batch device work into one call over the whole batch.  Scoped to
    ``repro_torch/core`` (model code legitimately loops over layers); a
    nested ``def`` starts at loop depth 0.
RPR005 metrics-unsurfaced
    A numeric ``EngineMetrics`` counter that ``summary()`` never reads
    is write-only telemetry: benchmarks and the regression gate can't
    see it, so regressions in what it counts ship silently.
RPR006 compile-in-hot-path
    ``torch.compile(...)``, ``torch.jit.script(...)``,
    ``torch.jit.trace(...)``, ``torch.cuda.graph(...)`` or
    ``torch.cuda.CUDAGraph()`` constructed anywhere but a setup path
    (module level, ``__init__``, ``_build*``) compiles, scripts or
    captures afresh on every call: the step pays a compile or a graph
    capture each time, the recompile storm the dispatch sentinel
    (``analysis/dispatch.py``) exists to catch at runtime.  An
    immediately invoked ``torch.compile(f)(x)`` is flagged wherever it
    stands.  Only dotted names rooted at ``torch`` match: the builtin
    ``compile`` is Python's, not PyTorch's (where the reference also
    flags a bare ``jit``).  Scoped to ``repro_torch/core``.
RPR007 host-sync-in-loop
    ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` (no
    arguments), ``torch.cuda.synchronize()`` or ``np.asarray`` /
    ``np.array`` / ``np.copy`` inside a Python-level loop waits for the
    card once per iteration: the host stops queueing work until every
    kernel before it has run, so the card idles between iterations.
    Hoist the transfer out of the loop and index the host copy.  The
    loop's header counts as inside the loop.  Scoped to
    ``repro_torch/core``.
RPR008 kernel-no-contract
    A function in ``repro_torch/kernels`` that launches a hand-written
    kernel (calls ``kernel_fn``, the ctypes entry point of
    ``kernels/build.py``) with no ``raise`` in it: a bad shape, dtype or
    device reaches the CUDA code unchecked, where it reads out of bounds
    or fails as an opaque launch error.  Every launcher must validate
    its operands and raise.  As in the reference, any ``raise`` in the
    function satisfies the rule: a launcher that raises only on the
    launch's return code passes, and its argument contract is then the
    caller's (``flash_attention.py::_launch`` runs after ``_on_card``).
RPR009 params-unvalidated
    RPR003 generalized to the per-request/-tenant parameter dataclasses:
    every ``SamplingParams`` / ``SLOParams`` / ``TenantTier`` field must
    be mentioned by ``__post_init__`` (same ``self.<field>`` /
    registry-loop string-literal detection).  These objects ride every
    request into the engine's hot paths, where a bad knob surfaces as a
    wrong token or an opaque launch error instead of a config-time
    ValueError.

Run as ``python -m repro_torch.analysis.lint src/repro_torch chip_smoke.py
tests/`` (non-zero exit on findings).  ``--select``/``--ignore`` take
comma-separated codes or names; ``--format github`` emits workflow
annotations for a CI lint job.  A finding is suppressed by a
``# rpr: noqa`` comment on its line (all rules) or
``# rpr: noqa[RPR002,RPR004]`` (those rules only).  Stdlib-only on
purpose: a CI lint job and pre-commit hooks run it without torch or
numpy installed.

Adding a rule: subclass ``Rule``, emit ``Finding``s from ``check``, add
an instance to ``RULES``, and seed ``tests/test_torch_lint.py`` with a
fixture that triggers it (rules must be proven live, not vacuous).
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Set


class Finding(NamedTuple):
    path: str
    line: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _decorator_name(node: ast.expr) -> str:
    """Rightmost dotted name of a decorator, unwrapping calls:
    ``@dataclasses.dataclass(frozen=True)`` -> ``dataclass``."""
    if isinstance(node, ast.Call):
        node = node.func
    while isinstance(node, ast.Attribute):
        node = ast.Name(id=node.attr)
    return node.id if isinstance(node, ast.Name) else ""


def _is_dataclass(node: ast.ClassDef) -> bool:
    return any(_decorator_name(d) == "dataclass" for d in node.decorator_list)


def _call_root(node: ast.expr) -> Optional[str]:
    """Root name of a call target: ``jnp.zeros`` -> ``jnp``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _callee_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    return f.id if isinstance(f, ast.Name) else ""


class Rule:
    code = ""
    name = ""
    # only lint files whose posix path contains this substring ("" = all)
    scope = ""
    # skip files whose posix path contains this substring ("" = none)
    exclude = ""

    def applies(self, path: str) -> bool:
        p = Path(path).as_posix()
        return self.scope in p and not (self.exclude and self.exclude in p)

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        raise NotImplementedError


_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set,
                     ast.ListComp, ast.DictComp, ast.SetComp)
# calls allowed as defaults: dataclasses.field and immutable constructors
_DEFAULT_CALL_ALLOW = {"field", "frozenset", "tuple", "MappingProxyType"}


class MutableDefault(Rule):
    code = "RPR001"
    name = "mutable-default"

    def _flag(self, node: ast.expr, where: str) -> Iterator[Finding]:
        if isinstance(node, _MUTABLE_LITERALS):
            yield Finding("", node.lineno, self.code,
                          f"mutable literal default on {where}: one instance "
                          "is shared by every call/construction; use "
                          "field(default_factory=...) (or None + init)")
        elif isinstance(node, ast.Call) and \
                _callee_name(node) not in _DEFAULT_CALL_ALLOW:
            yield Finding("", node.lineno, self.code,
                          f"call default on {where} runs ONCE at definition "
                          "time and shares the result (the PR-3 "
                          "Request.sampling bug class); use "
                          "field(default_factory=...)")

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                for default in (*args.defaults, *args.kw_defaults):
                    if default is not None:
                        yield from self._flag(
                            default, f"argument of {node.name}()")
            elif isinstance(node, ast.ClassDef) and _is_dataclass(node):
                for stmt in node.body:
                    value = None
                    if isinstance(stmt, (ast.AnnAssign, ast.Assign)):
                        value = stmt.value
                    if value is not None:
                        yield from self._flag(
                            value, f"dataclass field of {node.name}")


class BareAssert(Rule):
    code = "RPR002"
    name = "bare-assert"
    exclude = "tests/"      # pytest asserts are the idiom there

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.Assert):
                yield Finding("", node.lineno, self.code,
                              "bare assert on a runtime path is stripped "
                              "under python -O; raise an explicit exception")


class ServeConfigValidated(Rule):
    code = "RPR003"
    name = "serveconfig-unvalidated"

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == "ServeConfig":
                yield from self._check_class(node)

    def _check_class(self, cls: ast.ClassDef) -> Iterator[Finding]:
        fields = {}     # name -> lineno
        post_init = None
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                ann = ast.unparse(stmt.annotation)
                if not ann.startswith("ClassVar"):
                    fields[stmt.target.id] = stmt.lineno
            elif isinstance(stmt, ast.FunctionDef) and \
                    stmt.name == "__post_init__":
                post_init = stmt
        if not fields:
            return
        mentioned = set()
        if post_init is not None:
            for node in ast.walk(post_init):
                if isinstance(node, ast.Attribute) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == "self":
                    mentioned.add(node.attr)
                elif isinstance(node, ast.Constant) and \
                        isinstance(node.value, str):
                    mentioned.add(node.value)
        for name, line in sorted(fields.items(), key=lambda kv: kv[1]):
            if name not in mentioned:
                yield Finding(
                    "", line, self.code,
                    f"{cls.name}.{name} is never validated in "
                    "__post_init__: a bad value should die at construction "
                    "with a clear message, not deep inside the engine")


class ParamsValidated(ServeConfigValidated):
    """RPR009: RPR003's contract generalized to the per-request/-tenant
    parameter dataclasses (``SamplingParams``, ``SLOParams``,
    ``TenantTier``) — a field added to any of them without a validation
    mention in ``__post_init__`` ships an unvalidated knob straight into
    the engine's hot paths."""

    code = "RPR009"
    name = "params-unvalidated"
    classes = ("SamplingParams", "SLOParams", "TenantTier")

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name in self.classes:
                yield from self._check_class(node)



def _dotted(node: ast.expr) -> str:
    """Dotted name of a call target: ``torch.cuda.synchronize`` ->
    ``"torch.cuda.synchronize"`` ("" for anything but names and
    attributes)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    return ".".join([node.id] + parts[::-1])


class _LoopVisitor(ast.NodeVisitor):
    """Tracks the Python-level loop depth; a nested function def is
    called elsewhere, so its body starts at depth 0.  The loop header
    is visited at the loop's depth."""

    def __init__(self):
        self.loop_depth = 0

    def _loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _loop
    visit_While = _loop

    def _func(self, node):
        saved, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = saved

    visit_FunctionDef = _func
    visit_AsyncFunctionDef = _func


class TorchInLoop(Rule):
    code = "RPR004"
    name = "torch-in-loop"
    scope = "repro_torch/core"

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        findings: List[Finding] = []
        rule = self

        class V(_LoopVisitor):
            def visit_Call(self, node):
                if self.loop_depth and _call_root(node.func) in ("torch", "F"):
                    findings.append(Finding(
                        "", node.lineno, rule.code,
                        f"{ast.unparse(node.func)}() inside a Python-level "
                        "loop launches a kernel per iteration on the host "
                        "path; batch it over the rows or use numpy"))
                self.generic_visit(node)

        V().visit(tree)
        yield from findings

class MetricsSurfaced(Rule):
    code = "RPR005"
    name = "metrics-unsurfaced"

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == "EngineMetrics":
                yield from self._check_class(node)

    def _check_class(self, cls: ast.ClassDef) -> Iterator[Finding]:
        counters = {}   # numeric field name -> lineno
        summary = None
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                ann = ast.unparse(stmt.annotation)
                if ann in ("int", "float"):
                    counters[stmt.target.id] = stmt.lineno
            elif isinstance(stmt, ast.FunctionDef) and stmt.name == "summary":
                summary = stmt
        read = set()
        if summary is not None:
            for node in ast.walk(summary):
                if isinstance(node, ast.Attribute) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == "self":
                    read.add(node.attr)
        for name, line in sorted(counters.items(), key=lambda kv: kv[1]):
            if name not in read:
                yield Finding(
                    "", line, self.code,
                    f"EngineMetrics.{name} is never read in summary(): "
                    "write-only telemetry is invisible to benchmarks and "
                    "the regression gate")




# compiled, scripted or captured callables (dotted, rooted at torch)
_COMPILE_CALLS = frozenset({"torch.compile", "torch.jit.script",
                            "torch.jit.trace", "torch.cuda.graph",
                            "torch.cuda.CUDAGraph"})
_SETUP_NAMES = ("__init__",)     # plus any function named _build*


class CompileInHotPath(Rule):
    code = "RPR006"
    name = "compile-in-hot-path"
    scope = "repro_torch/core"

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        findings: List[Finding] = []
        rule = self

        class V(ast.NodeVisitor):
            def __init__(self):
                self.stack: List[str] = []
                self.skip: Set[int] = set()

            def _func(self, node):
                self.stack.append(node.name)
                self.generic_visit(node)
                self.stack.pop()

            visit_FunctionDef = _func
            visit_AsyncFunctionDef = _func

            def visit_Call(self, node):
                if isinstance(node.func, ast.Call) and \
                        _dotted(node.func.func) in _COMPILE_CALLS:
                    findings.append(Finding(
                        "", node.lineno, rule.code,
                        f"{_dotted(node.func.func)}(f)(...) compiles and "
                        "invokes in one expression: the compiled callable "
                        "is thrown away, so every invocation pays the "
                        "compile"))
                    self.skip.add(id(node.func))
                name = _dotted(node.func)
                if name in _COMPILE_CALLS and id(node) not in self.skip:
                    in_setup = any(
                        n in _SETUP_NAMES or n.startswith("_build")
                        for n in self.stack)
                    if self.stack and not in_setup:
                        findings.append(Finding(
                            "", node.lineno, rule.code,
                            f"{name} constructed inside {self.stack[-1]}(): "
                            "a fresh compile or graph capture per call; "
                            "hoist to module level, __init__, or a _build* "
                            "method"))
                self.generic_visit(node)

        V().visit(tree)
        yield from findings


# host-sync callables flagged inside loops: attr calls with no arguments
# by name, dotted calls by (root, attr) or by their full name
_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_CALLS = frozenset({("np", "asarray"), ("np", "array"),
                         ("np", "copy"), ("numpy", "asarray"),
                         ("numpy", "array")})
_SYNC_DOTTED = frozenset({"torch.cuda.synchronize"})


class HostSyncInLoop(Rule):
    code = "RPR007"
    name = "host-sync-in-loop"
    scope = "repro_torch/core"

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        findings: List[Finding] = []
        rule = self

        class V(_LoopVisitor):
            def visit_Call(self, node):
                if self.loop_depth:
                    f = node.func
                    sync = None
                    if _dotted(f) in _SYNC_DOTTED:
                        sync = _dotted(f) + "()"
                    elif isinstance(f, ast.Attribute):
                        if f.attr in _SYNC_ATTRS and not node.args \
                                and not node.keywords:
                            sync = f".{f.attr}()"
                        elif (_call_root(f), f.attr) in _SYNC_CALLS:
                            sync = ast.unparse(f) + "()"
                    if sync is not None:
                        findings.append(Finding(
                            "", node.lineno, rule.code,
                            f"{sync} inside a Python-level loop waits for "
                            "the card once per iteration, so it idles "
                            "between them; hoist the transfer out of the "
                            "loop and index the host copy"))
                self.generic_visit(node)

        V().visit(tree)
        yield from findings


class KernelContract(Rule):
    code = "RPR008"
    name = "kernel-no-contract"
    scope = "repro_torch/kernels"

    def check(self, tree: ast.Module, path: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            launches = any(
                isinstance(sub, ast.Call) and _callee_name(sub) == "kernel_fn"
                for sub in ast.walk(node))
            raises = any(isinstance(sub, ast.Raise) for sub in ast.walk(node))
            if launches and not raises:
                yield Finding(
                    "", node.lineno, self.code,
                    f"{node.name}() launches a kernel (kernel_fn) with no "
                    "explicit argument-contract check: a bad shape, dtype "
                    "or device reaches the CUDA code unchecked; validate "
                    "operands and raise at entry")


RULES: Sequence[Rule] = (MutableDefault(), BareAssert(),
                         ServeConfigValidated(), TorchInLoop(),
                         MetricsSurfaced(), CompileInHotPath(),
                         HostSyncInLoop(), KernelContract(),
                         ParamsValidated())


def _iter_files(paths: Sequence[str]) -> Iterator[Path]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        else:
            yield path


# "# rpr: noqa" (all rules) or "# rpr: noqa[RPR002,RPR004]" (those only)
_NOQA_RE = re.compile(r"#\s*rpr:\s*noqa(?:\[([A-Za-z0-9_,\s-]+)\])?")


def _suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """line number -> suppressed codes (None = every rule)."""
    sup: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _NOQA_RE.search(line)
        if m:
            codes = m.group(1)
            sup[i] = (None if codes is None else
                      {c.strip().upper() for c in codes.split(",") if c.strip()})
    return sup


def _suppressed(f: Finding, sup: Dict[int, Optional[Set[str]]]) -> bool:
    codes = sup.get(f.line, ())
    return codes is None or f.code in codes


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Optional[Sequence[str]] = None) -> List[Finding]:
    rules = [r for r in RULES if select is None or r.code in select
             or r.name in select]
    if ignore:
        rules = [r for r in rules
                 if r.code not in ignore and r.name not in ignore]
    findings: List[Finding] = []
    for file in _iter_files(paths):
        rel = str(file)
        try:
            source = file.read_text()
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 0, "RPR000",
                                    f"syntax error: {e.msg}"))
            continue
        sup = _suppressions(source)
        for rule in rules:
            if not rule.applies(rel):
                continue
            findings.extend(f._replace(path=rel)
                            for f in rule.check(tree, rel)
                            if not _suppressed(f, sup))
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def _render_github(f: Finding) -> str:
    """GitHub Actions workflow annotation (shows inline on the PR diff)."""
    message = f.message.replace("%", "%25").replace("\n", "%0A")
    return (f"::error file={f.path},line={f.line},"
            f"title={f.code}::{message}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific AST lint (see module docstring for rules)")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes/names to run "
                         "(default: all)")
    ap.add_argument("--ignore", default=None,
                    help="comma-separated rule codes/names to skip")
    ap.add_argument("--format", default="text", choices=("text", "github"),
                    help="text: path:line: CODE message; github: workflow "
                         "annotations for a CI lint job")
    args = ap.parse_args(argv)
    select = args.select.split(",") if args.select else None
    ignore = args.ignore.split(",") if args.ignore else None
    findings = lint_paths(args.paths, select, ignore)
    for f in findings:
        print(_render_github(f) if args.format == "github" else f.render())
    n_files = sum(1 for _ in _iter_files(args.paths))
    print(f"{len(findings)} finding(s) in {n_files} file(s) "
          f"[{', '.join(r.code for r in RULES)}]")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
