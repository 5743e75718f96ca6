"""The port's own conventions, linted over the source (twin of
``repro/analysis/ast_rules.py``): rules ruff cannot express.

The reference's four rules (``traced-if``, ``host-call-in-jit``,
``blockspec-pad``, ``missing-interpret``) guard Pallas and ``jit`` code,
of which the port has none: not applicable here.  The port's rules:

``jax-import``
    An import of ``jax``, ``jaxlib`` or ``repro`` (the reference
    package).  The port stands alone; only its tests import both.

``kernel-fallback``
    A ``try`` whose body calls a kernel wrapper (a function of a kernel
    module other than its ``*_plain`` versions, or ``ops.launch``) and
    whose handler calls a ``*_plain`` function, returns, or passes.  A
    CUDA tensor launches the kernel or raises: a failed launch must not
    turn into the plain version's answer.

``cpu-fallback``
    A branch on ``torch.cuda.is_available()`` that moves work to the CPU
    (names the ``"cpu"`` device or calls ``.cpu()``) instead of raising.
    Asking for the card where there is none is an error.

``launch-outside-ops``
    A C entry point called through ``build.function`` anywhere but
    ``kernels/ops.py``: every launch goes through ``ops.launch``, which
    raises on a refusal and counts the launch.  The queries a wrapper may
    make of a library are exempt by name (:data:`QUERY_NAMES`: the
    budgets, capacities, plans and the checker's tables).

Each rule reports :class:`LintViolation` records; the CLI
(``python -m repro_torch.analysis.check --ast``) renders and serializes
them.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import List, Sequence

DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py")

#: Top-level packages the port never imports.
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")

#: The modules whose functions are kernel wrappers (their ``*_plain``
#: functions are the plain versions).
KERNEL_MODULES = ("ops", "rrr_expand", "greedy_pick", "lazy_greedy",
                  "topk_gain", "coverage", "bucket", "bucket_insert",
                  "coins")

#: C entry points a wrapper may call outside ``ops.launch``: the queries
#: that size a launch and the checker's tables, never a launch.
QUERY_NAMES = re.compile(
    r"(_budget|_capacity|_per_machine|_cluster)$|^kernel_|^launch_smem$")

#: The one module that may call C entry points that launch.
OPS_MODULE = "kernels/ops.py"


@dataclasses.dataclass(frozen=True)
class LintViolation:
    rule: str
    file: str
    line: int
    message: str

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name for a call target or attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _calls(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub, _dotted(sub.func)


# ----------------------------------------------------------- jax-import
def _check_import(node, path: str, out: List[LintViolation]):
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif node.level == 0 and node.module:
        names = [node.module]
    else:
        return
    for name in names:
        if name.split(".")[0] in FORBIDDEN_IMPORTS:
            out.append(LintViolation(
                "jax-import", path, node.lineno,
                f"import of {name!r}: the port imports nothing of jax, "
                "jaxlib or the reference package"))


# ------------------------------------------------------ kernel-fallback
def _is_plain(name: str) -> bool:
    return name.rsplit(".", 1)[-1].endswith("_plain")


def _reaches_kernel(body) -> bool:
    for stmt in body:
        for _, name in _calls(stmt):
            head, _, tail = name.rpartition(".")
            if name == "launch" or (head.rsplit(".", 1)[-1] in KERNEL_MODULES
                                    and tail and not _is_plain(name)):
                return True
    return False


def _falls_back(handler: ast.ExceptHandler) -> bool:
    if all(isinstance(s, ast.Pass) for s in handler.body):
        return True
    for stmt in handler.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Return):
                return True
        if any(_is_plain(name) for _, name in _calls(stmt)):
            return True
    return False


def _check_try(node: ast.Try, path: str, out: List[LintViolation]):
    if not _reaches_kernel(node.body):
        return
    for handler in node.handlers:
        if _falls_back(handler):
            out.append(LintViolation(
                "kernel-fallback", path, handler.lineno,
                "a kernel call's failure is caught and answered (a plain "
                "version, a return or a pass): a CUDA tensor launches the "
                "kernel or raises"))


# --------------------------------------------------------- cpu-fallback
def _asks_for_card(test: ast.AST) -> bool:
    return any(name.endswith("cuda.is_available")
               for _, name in _calls(test))


def _moves_to_cpu(body) -> bool:
    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Raise):
                return False
    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Constant) and sub.value == "cpu":
                return True
            if (isinstance(sub, ast.Call) and isinstance(sub.func,
                                                         ast.Attribute)
                    and sub.func.attr == "cpu"):
                return True
    return False


def _check_branch(node, path: str, out: List[LintViolation]):
    if not _asks_for_card(node.test):
        return
    if isinstance(node, ast.IfExp):
        branches = ([node.body], [node.orelse])
    else:
        branches = (node.body, node.orelse)
    if any(_moves_to_cpu(b) for b in branches):
        out.append(LintViolation(
            "cpu-fallback", path, node.lineno,
            "a branch on torch.cuda.is_available() moves the work to the "
            "CPU: asking for the card where there is none must raise"))


# --------------------------------------------------- launch-outside-ops
def _entry_name(node: ast.Call):
    """The literal entry-point name of a ``build.function`` call (an
    f-string gives its constant tail), or None."""
    if len(node.args) < 2:
        return None
    arg = node.args[1]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if (isinstance(arg, ast.JoinedStr) and arg.values
            and isinstance(arg.values[-1], ast.Constant)):
        return arg.values[-1].value
    return None


def _check_function_call(node: ast.Call, path: str,
                         out: List[LintViolation]):
    if path.replace("\\", "/").endswith(OPS_MODULE):
        return
    name = _entry_name(node)
    if name is not None and QUERY_NAMES.search(name):
        return
    out.append(LintViolation(
        "launch-outside-ops", path, node.lineno,
        f"C entry point {name or '<computed>'!r} called through "
        "build.function outside kernels/ops.py: launch through ops.launch "
        "(it raises on a refusal and counts the launch)"))


# --------------------------------------------------------------- driver
def lint_source(source: str, path: str) -> List[LintViolation]:
    """All rule violations in one file's source text."""
    out: List[LintViolation] = []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        out.append(LintViolation("syntax", path, exc.lineno or 0,
                                 f"unparseable: {exc.msg}"))
        return out
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            _check_import(node, path, out)
        elif isinstance(node, ast.Try):
            _check_try(node, path, out)
        elif isinstance(node, (ast.If, ast.IfExp)):
            _check_branch(node, path, out)
        elif (isinstance(node, ast.Call)
                and _dotted(node.func).endswith("build.function")):
            _check_function_call(node, path, out)
    return sorted(out, key=lambda v: (v.file, v.line, v.rule))


def lint_paths(roots: Sequence[str] = DEFAULT_ROOTS,
               repo_root: str = ".") -> List[LintViolation]:
    """Lint every ``*.py`` under the given roots (a root may be a file)."""
    base = pathlib.Path(repo_root)
    out: List[LintViolation] = []
    for root in roots:
        top = base / root
        paths = [top] if top.is_file() else sorted(top.rglob("*.py"))
        for path in paths:
            rel = str(path.relative_to(base))
            out.extend(lint_source(path.read_text(), rel))
    return out
