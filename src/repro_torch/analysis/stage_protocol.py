"""The stage-protocol pass: the port's drivers checked against the plane
contract without running them.

Linearizes each contract driver's AST into a sequence of data-plane
EFFECTS (``plane_contract.EFFECT_OF_CALL``), splicing the engine's
callbacks in at their call sites and its inlined helpers where they are
called, and taking only the branch a driver spec ``assume``s where an
``if`` tests it; then checks the ordering and fusion rules of the
driver's protocol on that sequence:

* restore-before-use      — no device restore after the attend launch of
                            its (layer, group) window;
* writeback-before-drop   — a device drop or HBM layer evict follows a
                            FlashD2H save in the same or an enclosing
                            window, and an in-window drop carries the
                            one-stage eviction ``protect=``;
* fused-transfer          — at most one fused save / load / restore per
                            window, and no per-request save or restore;
* ctx-lifetime            — the one-layer prefill context is read only
                            inside the group callback;
* launches-per-iteration  — no stage launch inside a loop over requests;
* no-sync-in-dispatch-window — nothing in an async callback blocks on the
                            device (PyTorch's ``.cpu()``, ``.item()``,
                            ``.tolist()``, ``.numpy()``, a ``synchronize``,
                            a wait on a copy, a blocking readback or a
                            blocking obs export).

Purely syntactic: nothing is imported or executed.  A driver, callback or
inline that is not found raises ``LookupError``: a renamed driver must
fail the pass, not pass it empty.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.core import plane_contract as pc

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _parse(repo_root: Path, file: str,
           cache: Dict[str, ast.Module]) -> ast.Module:
    if file not in cache:
        cache[file] = ast.parse((repo_root / file).read_text(
            encoding="utf-8"), filename=file)
    return cache[file]


def _child_def(scope: ast.AST, name: str) -> Optional[ast.AST]:
    """The def or class ``name`` in ``scope``'s body, searching through
    its compound statements (a callback defined inside a loop) but not
    into other defs."""
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop(0)
        if isinstance(node, _DEFS):
            if node.name == name:
                return node
            continue
        if isinstance(node, ast.stmt):
            todo.extend(ast.iter_child_nodes(node))
    return None


def find_def(tree: ast.Module, qualname: str) -> Optional[ast.AST]:
    """Locate a (possibly nested) def or class by dotted qualname."""
    scope: Optional[ast.AST] = tree
    for part in qualname.split("."):
        scope = _child_def(scope, part)
        if scope is None:
            return None
    return scope


def _def_body(repo_root: Path, file: str, qualname: str,
              cache: Dict[str, ast.Module]) -> ast.AST:
    node = find_def(_parse(repo_root, file, cache), qualname)
    if node is None:
        raise LookupError(f"plane contract: {qualname} not found in {file}")
    return node


def callee_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _expr_names(node: ast.AST) -> set:
    """Terminal Name ids and Attribute attrs in an expression."""
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


@dataclasses.dataclass
class Effect:
    kind: str
    sub: str
    call: str
    file: str
    line: int
    stack: Tuple[int, ...]          # enclosing loop ids, outermost first
    batch: bool                     # inside a loop over requests
    in_callback: bool
    kwargs: Tuple[str, ...]


class _Linearizer:
    """Walks a driver body in source order collecting effects; loops push
    a window onto the stack; a callback's or an inline's body is walked
    where it is called, in place of recording the call."""

    def __init__(self, repo_root: Path, driver: pc.DriverSpec,
                 cache: Dict[str, ast.Module]):
        self.repo_root = repo_root
        self.driver = driver
        self.cache = cache
        self.effects: List[Effect] = []
        self.facts = dict(driver.assume)
        self.cb_bodies = {cb.local_name: (cb.file, _def_body(
            repo_root, cb.file, cb.qualname, cache))
            for cb in driver.callbacks}
        self.inline_bodies = {cb.local_name: (cb.file, _def_body(
            repo_root, cb.file, cb.qualname, cache))
            for cb in driver.inlines}
        self._active: set = set()          # bodies being walked (no loops)

    def run(self) -> List[Effect]:
        node = _def_body(self.repo_root, self.driver.file,
                         self.driver.qualname, self.cache)
        self._body(node.body, self.driver.file, (), False, False)
        return self.effects

    def _decide(self, test: ast.AST) -> Optional[bool]:
        """The value ``assume`` gives an ``if`` test, or None."""
        src = ast.unparse(test)
        if src in self.facts:
            return self.facts[src]
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            v = self._decide(test.operand)
            return None if v is None else not v
        if (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.Is, ast.IsNot))):
            flip = ast.Compare(left=test.left, comparators=test.comparators,
                               ops=[ast.IsNot() if isinstance(
                                   test.ops[0], ast.Is) else ast.Is()])
            v = self.facts.get(ast.unparse(flip))
            return None if v is None else not v
        if isinstance(test, ast.BoolOp):
            vals = [self._decide(v) for v in test.values]
            stop = isinstance(test.op, ast.Or)    # the value that decides
            if stop in vals:
                return stop
            if all(v is (not stop) for v in vals):
                return not stop
        return None

    def _is_batch_loop(self, loop: ast.AST) -> bool:
        return bool(_expr_names(loop.iter) & set(self.driver.batch_iterables))

    def _body(self, stmts, file, stack, batch, in_cb) -> None:
        for stmt in stmts:
            self._stmt(stmt, file, stack, batch, in_cb)

    def _splice(self, key, body, file, stack, batch, in_cb) -> None:
        if key in self._active:
            return
        self._active.add(key)
        self._body(body, file, stack, batch, in_cb)
        self._active.discard(key)

    def _stmt(self, stmt, file, stack, batch, in_cb) -> None:
        if isinstance(stmt, _DEFS):
            return                          # runs at call time, not here
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._exprs(stmt.iter, file, stack, batch, in_cb)
            self._body(stmt.body, file, stack + (id(stmt),),
                       batch or self._is_batch_loop(stmt), in_cb)
            self._body(stmt.orelse, file, stack, batch, in_cb)
            return
        if isinstance(stmt, ast.While):
            self._exprs(stmt.test, file, stack, batch, in_cb)
            self._body(stmt.body, file, stack + (id(stmt),), batch, in_cb)
            self._body(stmt.orelse, file, stack, batch, in_cb)
            return
        if isinstance(stmt, ast.If):
            self._exprs(stmt.test, file, stack, batch, in_cb)
            taken = self._decide(stmt.test)
            if taken is not False:
                self._body(stmt.body, file, stack, batch, in_cb)
            if taken is not True:
                self._body(stmt.orelse, file, stack, batch, in_cb)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._exprs(item.context_expr, file, stack, batch, in_cb)
            self._body(stmt.body, file, stack, batch, in_cb)
            return
        if isinstance(stmt, ast.Try):
            for part in (stmt.body, *(h.body for h in stmt.handlers),
                         stmt.orelse, stmt.finalbody):
                self._body(part, file, stack, batch, in_cb)
            return
        self._exprs(stmt, file, stack, batch, in_cb)

    def _exprs(self, node, file, stack, batch, in_cb) -> None:
        """Collect effect calls inside one statement or expression, in
        field order (arguments before the call), skipping nested function
        bodies."""
        if node is None or isinstance(node, _FUNCS):
            return
        if not isinstance(node, ast.Call):
            for child in ast.iter_child_nodes(node):
                self._exprs(child, file, stack, batch, in_cb)
            return
        for child in ast.iter_child_nodes(node):
            self._exprs(child, file, stack, batch, in_cb)
        f = node.func
        if isinstance(f, ast.Name) and f.id in self.cb_bodies:
            cb_file, cb_node = self.cb_bodies[f.id]
            self._splice(("cb", f.id), cb_node.body, cb_file, stack, batch,
                         True)
            return
        if isinstance(f, ast.Attribute) and f.attr in self.inline_bodies:
            in_file, in_node = self.inline_bodies[f.attr]
            self._splice(("inline", f.attr), in_node.body, in_file, stack,
                         batch, in_cb)
            return
        name = callee_name(node)
        eff = pc.EFFECT_OF_CALL.get(name) if name else None
        if eff is not None:
            self.effects.append(Effect(
                kind=eff[0], sub=eff[1], call=name, file=file,
                line=node.lineno, stack=stack, batch=batch,
                in_callback=in_cb,
                kwargs=tuple(kw.arg for kw in node.keywords if kw.arg)))


def _related(a: Tuple[int, ...], b: Tuple[int, ...]) -> bool:
    """True when one window stack encloses (is a prefix of) the other."""
    n = min(len(a), len(b))
    return a[:n] == b[:n]


_WINDOWED = ("staged-decode", "hybrid-plane", "staged-decode-async",
             "hybrid-plane-async")


def check_driver(repo_root: Path, driver: pc.DriverSpec,
                 cache: Dict[str, ast.Module]) -> List[Finding]:
    effects = _Linearizer(repo_root, driver, cache).run()
    rules = set(pc.PROTOCOL_RULES[driver.protocol])
    out: List[Finding] = []

    def flag(rule, eff, msg):
        out.append(Finding(rule=rule, file=eff.file, line=eff.line,
                           message=f"[{driver.name}] {msg}"))

    if pc.RULE_RESTORE_BEFORE_USE in rules:
        for i, e in enumerate(effects):
            if e.kind != "restore":
                continue
            attend = next((a for a in effects[:i]
                           if a.kind == "launch" and a.sub == "attend"
                           and _related(a.stack, e.stack)), None)
            if attend is not None:
                flag(pc.RULE_RESTORE_BEFORE_USE, e,
                     f"restore ({e.call}) placed AFTER the attend launch at "
                     f"line {attend.line}: restores must land between "
                     f"select and attend")

    if pc.RULE_WRITEBACK_BEFORE_DROP in rules:
        for i, e in enumerate(effects):
            if e.kind not in ("drop", "layer-evict"):
                continue
            if not any(d.kind == "d2h" and _related(d.stack, e.stack)
                       for d in effects[:i]):
                flag(pc.RULE_WRITEBACK_BEFORE_DROP, e,
                     f"{e.call} with no preceding FlashD2H write-back in "
                     f"its window: dropped data would exist nowhere")
            if (e.kind == "drop" and e.stack and driver.protocol in _WINDOWED
                    and "protect" not in e.kwargs):
                flag(pc.RULE_WRITEBACK_BEFORE_DROP, e,
                     f"in-window {e.call} without protect=: blocks selected "
                     f"by the imminent attend must be deferred one stage")

    if pc.RULE_FUSED_TRANSFER in rules:
        per_window: Dict[Tuple, Dict[str, int]] = {}
        for e in effects:
            if e.kind == "d2h" and e.sub == "unfused":
                flag(pc.RULE_FUSED_TRANSFER, e,
                     f"per-request {e.call}: the plane protocol requires ONE "
                     f"fused FlashD2H save per (layer, group)")
                continue
            if (e.kind == "restore" and e.sub == "unfused"
                    and driver.protocol != "legacy"):
                flag(pc.RULE_FUSED_TRANSFER, e,
                     f"per-request {e.call}: use the fused batch restore")
                continue
            if e.kind in ("d2h", "h2d", "restore"):
                seen = per_window.setdefault(e.stack, {})
                seen[e.kind] = seen.get(e.kind, 0) + 1
                if seen[e.kind] > 1:
                    flag(pc.RULE_FUSED_TRANSFER, e,
                         f"{seen[e.kind]} {e.kind} transfers in one (layer, "
                         f"group) window: transfers fuse to one per window")

    if pc.RULE_CTX_LIFETIME in rules:
        for e in effects:
            if e.kind == "ctx-read" and not e.in_callback:
                flag(pc.RULE_CTX_LIFETIME, e,
                     f"{e.call} outside the group callback: the one-layer "
                     f"context is overwritten by the next layer's launch")

    if pc.RULE_NO_SYNC_IN_DISPATCH_WINDOW in rules:
        for e in effects:
            if not e.in_callback:
                continue
            if e.kind == "sync":
                flag(pc.RULE_NO_SYNC_IN_DISPATCH_WINDOW, e,
                     f"blocking obs call ({e.call}) inside the async dispatch "
                     f"window: exports belong between iterations"
                     if e.sub == "obs" else
                     f"host-blocking sync ({e.call}) inside the async "
                     f"dispatch window: the driver's copy of the selected "
                     f"ids is the only allowed per-layer block")
            elif e.kind in ("pool-read", "ctx-read") and e.sub == "":
                flag(pc.RULE_NO_SYNC_IN_DISPATCH_WINDOW, e,
                     f"blocking readback ({e.call}) inside the async dispatch "
                     f"window: use {e.call}_async and let the host stage "
                     f"worker wait for it")

    if pc.RULE_LAUNCHES in rules:
        for e in effects:
            if e.kind == "launch" and e.batch:
                flag(pc.RULE_LAUNCHES, e,
                     f"stage launch ({e.call}) inside a per-request loop: "
                     f"launches must stay O(num_layers) per iteration")
    return out


def run(repo_root: Path, target: pc.AnalysisTarget) -> List[Finding]:
    cache: Dict[str, ast.Module] = {}
    out: List[Finding] = []
    for driver in target.drivers:
        out.extend(check_driver(repo_root, driver, cache))
    return out
