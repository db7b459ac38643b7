# Port of repro/analysis/lint.py: the collective and host-call rules are rewritten for the port.
"""The repo-invariant lint.

``ast``-based rules enforcing invariants a generic linter cannot express:

``raw-collective``
    No ``torch.distributed`` call, and no call of the private collective
    helpers (``_all_to_all``, ``_all_gather_lanes``, ``_note``), outside
    ``core/nap_collectives.py``.  Every collective must go through the NAP
    wrappers, which log each step, so the communication audit's strategy
    signatures stay exhaustive.

``async-blocking``
    No blocking ``AMGService`` / ``Ticket.result`` calls inside ``async def``
    bodies — the deadlock class the wire server routes around via
    ``ticket_future`` / ``asyncio.to_thread``.  A nested *sync* ``def``
    (e.g. a done-callback) resets the scope.

``captured-host-call``
    No ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
    ``torch.cuda.synchronize``, ``time.*`` or ``print`` inside a body that a
    CUDA graph captures: the program methods of ``DistHierarchy``
    (``resid_norm``, ``cycle``, ``vcycle``, ``pcg_init``, ``pcg_step``, their
    ``*_m`` twins) and every ``DistHierarchy`` method they call.  Such a
    call breaks the capture or bakes one value into the graph.

``frozen-mutation``
    No attribute assignment on frozen-dataclass instances and no
    ``object.__setattr__`` escape hatch outside ``__post_init__`` — state
    evolution goes through ``dataclasses.replace`` so config/plan identity
    stays hashable and cache-safe.

Suppression markers:

* ``# comm-audit: allow <tag>`` on the violating line — documented,
  per-site exception; the tag is the rationale label.
* ``# comm-audit: allow-file <rule>`` anywhere in the module — exempts the
  whole file from that rule.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from ..amg.programs import PROGRAMS
from .records import LintViolation

PRIVATE_COLLECTIVES = frozenset({"_all_to_all", "_all_gather_lanes", "_note"})
BLOCKING_METHODS = frozenset({"result", "update_wire", "drain"})
#: class name → the methods a CUDA graph captures (with every method of
#: the class they call)
CAPTURED_ROOTS = {"DistHierarchy": frozenset(PROGRAMS)}
HOST_METHODS = frozenset({"item", "cpu", "numpy", "tolist"})
HOST_CALLS = frozenset({"torch.cuda.synchronize", "print"})

_ALLOW_LINE = re.compile(r"#\s*comm-audit:\s*allow\s+(\S+)")
_ALLOW_FILE = re.compile(r"#\s*comm-audit:\s*allow-file\s+(\S+)")


def _dotted(node: ast.AST) -> str | None:
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; None for
    non-name chains."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def collect_frozen_classes(trees: dict[str, ast.Module]) -> set[str]:
    """Names of every ``@dataclass(frozen=True)`` class across the tree."""
    frozen: set[str] = set()
    for tree in trees.values():
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                name = _dotted(dec.func)
                if not name or name.rsplit(".", 1)[-1] != "dataclass":
                    continue
                for kw in dec.keywords:
                    if (kw.arg == "frozen"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True):
                        frozen.add(node.name)
    return frozen


def captured_methods(cls: ast.ClassDef, roots) -> set[str]:
    """The methods of ``cls`` a capture runs: ``roots`` (class-level aliases
    such as ``cycle_m = cycle`` resolved) and every method they reach
    through ``self.<method>``."""
    defs = {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    alias = {t.id: n.value.id for n in cls.body if isinstance(n, ast.Assign)
             and isinstance(n.value, ast.Name)
             for t in n.targets if isinstance(t, ast.Name)}
    todo = [alias.get(r, r) for r in roots]
    seen: set[str] = set()
    while todo:
        name = todo.pop()
        if name in seen or name not in defs:
            continue
        seen.add(name)
        for node in ast.walk(defs[name]):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                todo.append(alias.get(node.attr, node.attr))
    return seen


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, lines: list[str], frozen: set[str],
                 file_allows: set[str]):
        self.path = path
        self.lines = lines
        self.frozen = frozen
        self.file_allows = file_allows
        self.violations: list[LintViolation] = []
        self._fn_stack: list[str] = []      # "async" | "sync"
        # per enclosing class: (its captured methods, fn depth of its body)
        self._class_stack: list[tuple[set[str], int]] = []
        self._captured_depth = 0
        self._frozen_vars: list[set[str]] = [set()]
        self._in_post_init = False
        self._dist_aliases: set[str] = set()   # names bound to torch.distributed
        self._is_nap_core = path.replace("\\", "/").endswith(
            "core/nap_collectives.py")

    # -- bookkeeping -------------------------------------------------------
    def _allowed(self, rule: str, line: int) -> bool:
        if rule in self.file_allows:
            return True
        text = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        return bool(_ALLOW_LINE.search(text))

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        if not self._allowed(rule, node.lineno):
            self.violations.append(
                LintViolation(rule, self.path, node.lineno, message))

    # -- scopes ------------------------------------------------------------
    def visit_Module(self, node: ast.Module) -> None:
        # pre-scan: every local name torch.distributed (or a member) is
        # imported under
        for sub in ast.walk(node):
            if isinstance(sub, ast.Import):
                for a in sub.names:
                    if a.name.startswith("torch.distributed") and a.asname:
                        self._dist_aliases.add(a.asname)
            elif (isinstance(sub, ast.ImportFrom) and sub.module
                  and (sub.module.startswith("torch.distributed")
                       or (sub.module == "torch"
                           and any(a.name == "distributed"
                                   for a in sub.names)))):
                for a in sub.names:
                    if sub.module != "torch" or a.name == "distributed":
                        self._dist_aliases.add(a.asname or a.name)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        roots = CAPTURED_ROOTS.get(node.name, ())
        self._class_stack.append((captured_methods(node, roots),
                                  len(self._fn_stack)))
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_fn(self, node, kind: str) -> None:
        captured = False
        if self._class_stack:
            methods, depth = self._class_stack[-1]
            captured = depth == len(self._fn_stack) and node.name in methods
        self._fn_stack.append(kind)
        self._captured_depth += captured
        frozen_here = set()
        for arg in (node.args.args + node.args.posonlyargs
                    + node.args.kwonlyargs):
            ann = arg.annotation
            name = ann and _dotted(ann)
            if (name and name.rsplit(".", 1)[-1] in self.frozen
                    and arg.arg != "self"):
                frozen_here.add(arg.arg)
        self._frozen_vars.append(frozen_here)
        was_post_init = self._in_post_init
        if node.name == "__post_init__":
            self._in_post_init = True
        self.generic_visit(node)
        self._in_post_init = was_post_init
        self._frozen_vars.pop()
        self._captured_depth -= captured
        self._fn_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_fn(node, "sync")

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_fn(node, "async")

    # -- rules -------------------------------------------------------------
    def visit_Await(self, node: ast.Await) -> None:
        # an awaited call yields to the event loop — by definition not a
        # blocking call (e.g. `await writer.drain()` on an asyncio stream)
        setattr(node.value, "_awaited", True)
        self.generic_visit(node)

    def _is_raw_collective(self, name: str, leaf: str) -> bool:
        if self._is_nap_core:
            return False
        head = name.split(".", 1)[0]
        return (name.startswith("torch.distributed.")
                or head in self._dist_aliases
                or leaf in PRIVATE_COLLECTIVES)

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func) or ""
        leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
                else name.rsplit(".", 1)[-1])

        if self._is_raw_collective(name, leaf):
            self._flag("raw-collective", node,
                       f"raw `{name or leaf}` call — route through "
                       f"repro_torch.core.nap_collectives so the comm "
                       f"audit's strategy signatures stay exhaustive")

        if (self._fn_stack and self._fn_stack[-1] == "async"
                and not getattr(node, "_awaited", False)):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in BLOCKING_METHODS):
                self._flag("async-blocking", node,
                           f"blocking `.{node.func.attr}()` call inside an "
                           f"`async def` body — route through ticket_future "
                           f"/ asyncio.to_thread")
            elif name == "time.sleep":
                self._flag("async-blocking", node,
                           "`time.sleep` inside an `async def` body — use "
                           "`await asyncio.sleep`")

        if self._captured_depth > 0 and (
                name in HOST_CALLS or name.startswith("time.")
                or (isinstance(node.func, ast.Attribute)
                    and leaf in HOST_METHODS)):
            self._flag("captured-host-call", node,
                       f"`{name or '.' + leaf}` inside a body a CUDA graph "
                       f"captures — it breaks the capture or bakes one "
                       f"value into the graph")

        if (name == "object.__setattr__" and not self._in_post_init):
            self._flag("frozen-mutation", node,
                       "`object.__setattr__` outside `__post_init__` — use "
                       "`dataclasses.replace`")
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # x = FrozenClass(...) makes x a frozen instance in this scope
        is_frozen_ctor = False
        if isinstance(node.value, ast.Call):
            vname = _dotted(node.value.func) or ""
            if vname.rsplit(".", 1)[-1] in self.frozen:
                is_frozen_ctor = True
        for tgt in node.targets:
            if is_frozen_ctor and isinstance(tgt, ast.Name):
                self._frozen_vars[-1].add(tgt.id)
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id in self._frozen_vars[-1]
                    and not self._in_post_init):
                self._flag("frozen-mutation", node,
                           f"assignment to `{tgt.value.id}.{tgt.attr}` on a "
                           f"frozen dataclass — use `dataclasses.replace`")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        ann = _dotted(node.annotation) or ""
        if (ann.rsplit(".", 1)[-1] in self.frozen
                and isinstance(node.target, ast.Name)):
            self._frozen_vars[-1].add(node.target.id)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        tgt = node.target
        if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                and tgt.value.id in self._frozen_vars[-1]
                and not self._in_post_init):
            self._flag("frozen-mutation", node,
                       f"augmented assignment to `{tgt.value.id}.{tgt.attr}`"
                       f" on a frozen dataclass — use `dataclasses.replace`")
        self.generic_visit(node)


def lint_source(src: str, path: str = "<string>",
                frozen: set[str] | None = None) -> list[LintViolation]:
    """Lint one module's source.  ``frozen`` injects tree-wide frozen-class
    names; when omitted, only classes defined in ``src`` are known."""
    tree = ast.parse(src, filename=path)
    if frozen is None:
        frozen = collect_frozen_classes({path: tree})
    file_allows = set(_ALLOW_FILE.findall(src))
    lines = src.splitlines()
    linter = _Linter(path, lines, frozen, file_allows)
    linter.visit(tree)
    return sorted(linter.violations, key=lambda v: (v.path, v.line, v.rule))


def lint_paths(root: str | Path) -> list[LintViolation]:
    """Lint every ``.py`` module under ``root`` (normally
    ``src/repro_torch``), with frozen-dataclass names collected tree-wide
    first so cross-module instances are tracked."""
    root = Path(root)
    sources: dict[str, str] = {}
    trees: dict[str, ast.Module] = {}
    for p in sorted(root.rglob("*.py")):
        rel = str(p)
        src = p.read_text()
        sources[rel] = src
        trees[rel] = ast.parse(src, filename=rel)
    frozen = collect_frozen_classes(trees)
    out: list[LintViolation] = []
    for rel, src in sources.items():
        out.extend(lint_source(src, rel, frozen=frozen))
    return out
