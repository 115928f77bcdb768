"""Contract lint: AST-based checks of the hand-maintained registries
against their use sites.

The port's copy of the JAX package's ``analysis/lint.py``, retargeted at
the port's tree: ``tools/nnslint.py`` of the port walks
``nnstreamer_tpu_torch/`` and reads the port's own metric and knob
registry doc, ``docs/torch-observability.md`` (:class:`LintTree`'s
``paths`` and ``docs``); a fixture tree is walked whole, its ``.md`` files
its docs, as in the JAX package.

Four registries hold the system together: the hook-point table
(``obs/hooks.py HOOK_SIGNATURES``), the ``nnstpu_*`` metric names of the
registry doc, the conf ``DEFAULTS`` knobs (plus ``SHORT_ENV`` spellings),
and the NNSQ ``ERROR_TYPES`` wire codes.  This module re-derives each
contract from the *target tree's source* (pure AST: no imports, so it
lints fixture trees and broken checkouts alike) and cross-verifies both
directions.

Checks (ids usable in ``# nnslint: disable=<id>`` and ``--checks``):

``hooks``
    every ``hooks.emit(name, ...)`` names a registered hook point and
    passes the registered arity (splat args skip the arity check).
``metrics``
    bidirectional drift: every metric name constructed in code appears
    in the docs, and every documented name exists in code.  Wildcard
    families (``nnstpu_pool_*``) cover any code name with the prefix;
    exposition suffixes (``_bucket``/``_sum``/``_count``) normalize.
``conf``
    every literal ``conf.get*(section, key)`` and every literal
    ``NNSTPU_*`` env read resolves to a ``DEFAULTS`` entry (directly,
    via NNSTPU_<SECTION>_<KEY> derivation, or via ``SHORT_ENV``) and is
    mentioned in the docs; every ``DEFAULTS`` knob is documented.
``wire-codes``
    every literal ``send_error(..., code=X)`` is a registered
    ``ERROR_TYPES`` code; every registered code has a typed exception
    class carrying it; every class-level ``code = "X"`` is registered.
``threads``
    every ``threading.Thread(...)`` is daemon, returned to a caller
    (ownership transfer, e.g. ``spawn_threads``), or provably joined /
    daemonized via its binding name in the same module.
``bare-except``
    no bare ``except:`` handlers — a worker loop that swallows
    ``SystemExit``/``KeyboardInterrupt`` cannot be drained.

Suppressions: ``# nnslint: disable=check1,check2`` on the finding's
line, or ``# nnslint: disable-next-line=...`` on the line above;
``disable=all`` silences every check for that line.

Baseline: a checked-in JSON file of accepted finding fingerprints
(:func:`load_baseline` / :func:`write_baseline`); CI fails only on
findings not in the baseline, so the gate catches *new* drift without
demanding an instant fix of historical debt.  Fingerprints are
line-number-free so unrelated edits don't invalidate the baseline.

CLI: ``python -m nnstreamer_tpu_torch.tools.nnslint``.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

ALL_CHECKS = ("hooks", "metrics", "conf", "wire-codes", "threads",
              "bare-except")

# dirs never scanned; per-check source-dir exclusions below
_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "build",
              "dist", ".eggs", "node_modules"}
# metric construction and thread hygiene are runtime-code contracts;
# tests assert on metric names and join their threads ad hoc
_NO_TEST_CHECKS = {"metrics", "threads"}

_METRIC_RE = re.compile(r"nnstpu_[a-z0-9_]+")
_METRIC_FULL_RE = re.compile(r"^nnstpu_[a-z0-9_]+$")
_DOC_METRIC_RE = re.compile(r"nnstpu_[a-z0-9_*]+")
_DOC_ENV_RE = re.compile(r"NNSTPU_[A-Z0-9_*]+")
_EXPO_SUFFIXES = ("_bucket", "_sum", "_count")
_SUPPRESS_RE = re.compile(
    r"#\s*nnslint:\s*disable(?P<next>-next-line)?=(?P<checks>[a-z\-,\s]+)")


@dataclass
class Finding:
    check: str
    path: str          # tree-relative, "/" separators
    line: int
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.check}:{self.path}:{self.message}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


@dataclass
class _PyFile:
    path: str          # relative
    source: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)


def _terminal_name(node) -> Optional[str]:
    """``self.a.b`` -> "b"; ``x`` -> "x" — the binding-name heuristic."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class LintTree:
    """A parsed source tree plus the registries extracted from it.

    ``paths`` (relative to ``root``) limits the walk to those directories or
    files (default: all of ``root``); ``docs`` names the ``.md`` files that
    hold the metric and knob registry (relative to ``root`` or absolute;
    default: every ``.md`` file the walk finds).  Finding paths are
    relative to ``root``."""

    def __init__(self, root: str, paths: Optional[Iterable[str]] = None,
                 docs: Optional[Iterable[str]] = None):
        self.root = os.path.abspath(root)
        self.paths = list(paths) if paths else None
        self.docs = list(docs) if docs is not None else None
        self.py: List[_PyFile] = []
        self.md: List[Tuple[str, List[str]]] = []   # (relpath, lines)
        self.errors: List[str] = []
        self._load()
        self._extract_registries()
        self._suppressions = self._scan_suppressions()

    # -- loading -----------------------------------------------------------

    def _walk(self):
        tops = [os.path.join(self.root, p) for p in self.paths] if self.paths else [self.root]
        for top in tops:
            if os.path.isfile(top):
                yield top
                continue
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
                for fname in sorted(filenames):
                    yield os.path.join(dirpath, fname)

    def _load(self) -> None:
        for full in self._walk():
            fname = os.path.basename(full)
            rel = os.path.relpath(full, self.root).replace(os.sep, "/")
            if fname.endswith(".py"):
                try:
                    with open(full, "r", encoding="utf-8",
                              errors="replace") as fh:
                        src = fh.read()
                    tree = ast.parse(src, filename=rel)
                except (OSError, SyntaxError) as exc:
                    self.errors.append(f"{rel}: unparseable: {exc}")
                    continue
                self.py.append(_PyFile(rel, src, tree, src.splitlines()))
            elif fname.endswith(".md") and self.docs is None:
                self._load_md(full, rel)
        for doc in self.docs or ():
            full = doc if os.path.isabs(doc) else os.path.join(self.root, doc)
            self._load_md(full, os.path.relpath(full, self.root).replace(os.sep, "/"))

    def _load_md(self, full: str, rel: str) -> None:
        try:
            with open(full, "r", encoding="utf-8", errors="replace") as fh:
                self.md.append((rel, fh.read().splitlines()))
        except OSError as exc:
            self.errors.append(f"{rel}: unreadable: {exc}")

    def _doc_text(self) -> str:
        return "\n".join("\n".join(lines) for _, lines in self.md)

    # -- registry extraction (AST only, works on fixture trees) ------------

    def _extract_registries(self) -> None:
        self.hook_signatures: Optional[Dict[str, Optional[int]]] = None
        self.defaults: Dict[str, Dict[str, str]] = {}
        self.defaults_loc: Optional[Tuple[str, int]] = None
        self.short_env: Dict[str, Optional[Tuple[str, str]]] = {}
        self.error_types: Dict[str, Tuple[str, str, int]] = {}  # code -> (cls, path, line)
        self.error_types_loc: Optional[Tuple[str, int]] = None
        self.code_classes: Dict[str, List[Tuple[str, str, int]]] = {}

        for pf in self.py:
            for node in ast.walk(pf.tree):
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    names = {_terminal_name(t) for t in targets}
                    value = node.value
                    if value is None:
                        continue
                    if "HOOK_SIGNATURES" in names and \
                            isinstance(value, ast.Dict):
                        self.hook_signatures = {}
                        for k, v in zip(value.keys, value.values):
                            name = _const_str(k)
                            if name is None:
                                continue
                            if isinstance(v, (ast.Tuple, ast.List)):
                                self.hook_signatures[name] = len(v.elts)
                            else:
                                self.hook_signatures[name] = None
                    elif "HOOKS" in names and self.hook_signatures is None \
                            and isinstance(value, (ast.Tuple, ast.List)):
                        # legacy names-only registry: arity unknown
                        sigs = {}
                        for el in value.elts:
                            name = _const_str(el)
                            if name is not None:
                                sigs[name] = None
                        if sigs:
                            self.hook_signatures = sigs
                    elif "DEFAULTS" in names and isinstance(value, ast.Dict):
                        self.defaults_loc = (pf.path, value.lineno)
                        for k, v in zip(value.keys, value.values):
                            sec = _const_str(k)
                            if sec is None or not isinstance(v, ast.Dict):
                                continue
                            entry = self.defaults.setdefault(sec, {})
                            for kk, vv in zip(v.keys, v.values):
                                key = _const_str(kk)
                                if key is not None:
                                    entry[key] = _const_str(vv) or ""
                    elif "SHORT_ENV" in names and isinstance(value, ast.Dict):
                        for k, v in zip(value.keys, value.values):
                            env = _const_str(k)
                            if env is None:
                                continue
                            if isinstance(v, (ast.Tuple, ast.List)) and \
                                    len(v.elts) == 2:
                                sec = _const_str(v.elts[0])
                                key = _const_str(v.elts[1])
                                self.short_env[env] = (sec, key) \
                                    if sec and key else None
                            else:
                                self.short_env[env] = None
                    elif "ERROR_TYPES" in names and isinstance(value, ast.Dict):
                        self.error_types_loc = (pf.path, value.lineno)
                        for k, v in zip(value.keys, value.values):
                            code = _const_str(k)
                            if code is None:
                                continue
                            cls = _terminal_name(v) or "?"
                            self.error_types[code] = (cls, pf.path, k.lineno)
                elif isinstance(node, ast.ClassDef):
                    for stmt in node.body:
                        if isinstance(stmt, ast.Assign):
                            tnames = {_terminal_name(t)
                                      for t in stmt.targets}
                            code = _const_str(stmt.value)
                            if "code" in tnames and code:
                                self.code_classes.setdefault(code, []).append(
                                    (node.name, pf.path, stmt.lineno))

    # -- suppressions ------------------------------------------------------

    def _scan_suppressions(self) -> Dict[str, Dict[int, Set[str]]]:
        out: Dict[str, Dict[int, Set[str]]] = {}
        for pf in self.py:
            per_line: Dict[int, Set[str]] = {}
            for i, line in enumerate(pf.lines, start=1):
                m = _SUPPRESS_RE.search(line)
                if not m:
                    continue
                checks = {c.strip() for c in m.group("checks").split(",")
                          if c.strip()}
                target = i + 1 if m.group("next") else i
                per_line.setdefault(target, set()).update(checks)
            if per_line:
                out[pf.path] = per_line
        return out

    def suppressed(self, finding: Finding) -> bool:
        checks = self._suppressions.get(finding.path, {}).get(finding.line)
        return bool(checks) and (finding.check in checks or "all" in checks)

    # -- helpers -----------------------------------------------------------

    def code_files(self, check: str) -> Iterable[_PyFile]:
        for pf in self.py:
            if check in _NO_TEST_CHECKS:
                first = pf.path.split("/", 1)[0]
                if first == "tests" or "/tests/" in pf.path:
                    continue
            yield pf


# ---------------------------------------------------------------------------
# checks


def _check_hooks(tree: LintTree) -> List[Finding]:
    out: List[Finding] = []
    sigs = tree.hook_signatures
    if sigs is None:
        return out  # no hook registry in this tree: nothing to verify
    for pf in tree.code_files("hooks"):
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            is_emit = (isinstance(fn, ast.Attribute) and fn.attr == "emit"
                       and isinstance(fn.value, ast.Name)
                       and "hooks" in fn.value.id)
            if not is_emit or not node.args:
                continue
            name = _const_str(node.args[0])
            if name is None:
                continue
            if name not in sigs:
                out.append(Finding(
                    "hooks", pf.path, node.lineno,
                    f"emit of unregistered hook point {name!r} "
                    f"(known: {', '.join(sorted(sigs))})"))
                continue
            arity = sigs[name]
            if arity is None:
                continue
            if any(isinstance(a, ast.Starred) for a in node.args):
                continue
            got = len(node.args) - 1
            if got != arity:
                out.append(Finding(
                    "hooks", pf.path, node.lineno,
                    f"hook {name!r} emitted with {got} args, "
                    f"signature takes {arity}"))
    return out


def _split_doc_metric_names(tree: LintTree):
    exact: Dict[str, Tuple[str, int]] = {}
    wildcards: Dict[str, Tuple[str, int]] = {}
    for rel, lines in tree.md:
        for i, line in enumerate(lines, start=1):
            for m in _DOC_METRIC_RE.finditer(line):
                name = m.group(0).rstrip("_")
                if "*" in name:
                    prefix = name.split("*", 1)[0]
                    if prefix == "nnstpu_":
                        continue  # the generic family mention in prose
                    wildcards.setdefault(prefix, (rel, i))
                else:
                    exact.setdefault(name, (rel, i))
    return exact, wildcards


def _code_metric_names(tree: LintTree) -> Dict[str, Tuple[str, int]]:
    names: Dict[str, Tuple[str, int]] = {}

    def add(name: str, pf: _PyFile, lineno: int) -> None:
        if name.endswith("_"):
            return  # the prefix of a dynamic family, not a name
        names.setdefault(name, (pf.path, lineno))

    for pf in tree.code_files("metrics"):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("counter", "gauge", "histogram",
                                       "summary") and node.args:
                name = _const_str(node.args[0])
                if name and name.startswith("nnstpu_"):
                    add(name, pf, node.lineno)
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                v = node.value
                if _METRIC_FULL_RE.match(v):
                    add(v, pf, node.lineno)
                elif "# TYPE" in v or "# HELP" in v:
                    # hand-rolled exposition strings (obs/collector.py)
                    for m in _METRIC_RE.finditer(v):
                        add(m.group(0), pf, node.lineno)
    return names


def _check_metrics(tree: LintTree) -> List[Finding]:
    out: List[Finding] = []
    if not tree.md:
        return out  # no docs in this tree: drift is undefined
    doc_exact, doc_wild = _split_doc_metric_names(tree)
    code = _code_metric_names(tree)

    def documented(name: str) -> bool:
        if name in doc_exact:
            return True
        return any(name == p.rstrip("_") or name.startswith(p)
                   for p in doc_wild)

    for name, (path, line) in sorted(code.items()):
        if not documented(name):
            out.append(Finding(
                "metrics", path, line,
                f"metric {name!r} is not documented in the registry doc"))

    code_names = set(code)
    for name, (rel, line) in sorted(doc_exact.items()):
        base = name
        for suf in _EXPO_SUFFIXES:
            if base.endswith(suf) and \
                    base[: -len(suf)] in (set(doc_exact) | code_names):
                base = base[: -len(suf)]
                break
        if base in code_names:
            continue
        # exposition-suffix forms of a live base name are fine
        out.append(Finding(
            "metrics", rel, line,
            f"documented metric {name!r} does not exist in code"))
    for prefix, (rel, line) in sorted(doc_wild.items()):
        covered = any(n == prefix.rstrip("_") or n.startswith(prefix)
                      for n in code_names)
        if not covered:
            out.append(Finding(
                "metrics", rel, line,
                f"documented metric family {prefix!r}* has no code names"))
    return out


_ENV_GETTERS = {"get", "getenv", "pop", "setdefault"}


def _env_name_reads(pf: _PyFile):
    """Yield (env_name, lineno) for literal NNSTPU_* env lookups."""
    for node in ast.walk(pf.tree):
        name = None
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _ENV_GETTERS \
                    and node.args:
                owner = _terminal_name(fn.value)
                if owner in ("environ", "os", "_environ"):
                    name = _const_str(node.args[0])
        elif isinstance(node, ast.Subscript):
            if _terminal_name(node.value) == "environ":
                name = _const_str(node.slice)
        if name and name.startswith("NNSTPU_"):
            yield name, node.lineno


def _env_to_knob(name: str, defaults: Dict[str, Dict[str, str]],
                 short_env: Dict[str, Optional[Tuple[str, str]]]):
    """Resolve an env spelling to a DEFAULTS knob; returns (section, key),
    None for registered knob-less spellings, or "unknown"."""
    if name in short_env:
        return short_env[name]
    rest = name[len("NNSTPU_"):]
    for sec in defaults:
        prefix = sec.upper() + "_"
        if rest.startswith(prefix):
            key = rest[len(prefix):].lower()
            if key in defaults[sec]:
                return (sec, key)
    return "unknown"


def _check_conf(tree: LintTree) -> List[Finding]:
    out: List[Finding] = []
    defaults = tree.defaults
    if not defaults:
        return out  # no DEFAULTS registry in this tree
    doc_text = tree._doc_text()
    has_docs = bool(tree.md)

    def doc_mentions(section: str, key: str) -> bool:
        env = f"NNSTPU_{section.upper()}_{key.upper()}"
        if env in doc_text or re.search(rf"\b{re.escape(key)}\b", doc_text):
            return True
        return any(v == (section, key) and k in doc_text
                   for k, v in tree.short_env.items())

    conf_getters = {"get", "get_bool", "get_int", "get_float", "get_path"}
    for pf in tree.code_files("conf"):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in conf_getters and \
                    _terminal_name(node.func.value) == "conf" and \
                    len(node.args) >= 2:
                sec = _const_str(node.args[0])
                key = _const_str(node.args[1])
                if sec is None or key is None:
                    continue
                if sec not in defaults:
                    out.append(Finding(
                        "conf", pf.path, node.lineno,
                        f"conf read of unknown section [{sec}]"))
                elif key not in defaults[sec]:
                    out.append(Finding(
                        "conf", pf.path, node.lineno,
                        f"conf read [{sec}] {key} has no DEFAULTS entry"))
                elif has_docs and not doc_mentions(sec, key):
                    out.append(Finding(
                        "conf", pf.path, node.lineno,
                        f"conf knob [{sec}] {key} is undocumented"))
        for env, lineno in _env_name_reads(pf):
            knob = _env_to_knob(env, defaults, tree.short_env)
            if knob == "unknown":
                out.append(Finding(
                    "conf", pf.path, lineno,
                    f"env read {env} resolves to no DEFAULTS knob or "
                    f"SHORT_ENV spelling"))
            elif has_docs and env not in doc_text and not (
                    isinstance(knob, tuple) and doc_mentions(*knob)):
                out.append(Finding(
                    "conf", pf.path, lineno,
                    f"env var {env} is undocumented"))
    if has_docs:
        conf_path, conf_line = tree.defaults_loc or ("conf.py", 1)
        for sec, keys in sorted(defaults.items()):
            for key in sorted(keys):
                if not doc_mentions(sec, key):
                    out.append(Finding(
                        "conf", conf_path, conf_line,
                        f"DEFAULTS knob [{sec}] {key} is undocumented"))
    return out


def _check_wire_codes(tree: LintTree) -> List[Finding]:
    out: List[Finding] = []
    if not tree.error_types:
        return out  # no wire-code registry in this tree
    for pf in tree.code_files("wire-codes"):
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = _terminal_name(node.func)
            if fname != "send_error":
                continue
            code = None
            for kw in node.keywords:
                if kw.arg == "code":
                    code = _const_str(kw.value)
            if code is None and len(node.args) >= 3:
                code = _const_str(node.args[2])
            if code and code not in tree.error_types:
                out.append(Finding(
                    "wire-codes", pf.path, node.lineno,
                    f"wire error code [{code}] sent but not registered "
                    f"in ERROR_TYPES"))
    for code, (cls, path, line) in sorted(tree.error_types.items()):
        carriers = tree.code_classes.get(code, [])
        if not carriers:
            out.append(Finding(
                "wire-codes", path, line,
                f"ERROR_TYPES code [{code}] has no exception class "
                f"carrying code = {code!r}"))
    for code, classes in sorted(tree.code_classes.items()):
        if code not in tree.error_types:
            cls, path, line = classes[0]
            out.append(Finding(
                "wire-codes", path, line,
                f"exception {cls} carries wire code [{code}] absent "
                f"from ERROR_TYPES (clients get a bare RuntimeError)"))
    return out


class _FunctionScope(ast.NodeVisitor):
    """Per-module pass answering "is this Thread provably owned":
    collects join/daemon targets and return-mentioned names."""

    def __init__(self):
        self.join_names: Set[str] = set()
        self.daemon_true_names: Set[str] = set()
        self.append_flows: List[Tuple[str, str]] = []  # (list_name, item_name)
        self.loop_flows: List[Tuple[str, str]] = []    # (iter_name, loop_var)

    def close(self) -> None:
        """Propagate joins through `for t in ts: t.join()` loops."""
        changed = True
        while changed:
            changed = False
            for iter_name, var in self.loop_flows:
                if var in self.join_names and iter_name not in self.join_names:
                    self.join_names.add(iter_name)
                    changed = True
                if var in self.daemon_true_names and \
                        iter_name not in self.daemon_true_names:
                    self.daemon_true_names.add(iter_name)
                    changed = True

    def visit_For(self, node: ast.For):
        iter_name = _terminal_name(node.iter)
        var = _terminal_name(node.target)
        if iter_name and var:
            self.loop_flows.append((iter_name, var))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            owner = _terminal_name(fn.value)
            if fn.attr == "join" and owner:
                self.join_names.add(owner)
            elif fn.attr == "append" and owner and node.args:
                item = _terminal_name(node.args[0])
                if item:
                    self.append_flows.append((owner, item))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        if isinstance(node.value, ast.Constant) and node.value.value is True:
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "daemon":
                    owner = _terminal_name(t.value)
                    if owner:
                        self.daemon_true_names.add(owner)
        self.generic_visit(node)


def _check_threads(tree: LintTree) -> List[Finding]:
    out: List[Finding] = []
    for pf in tree.code_files("threads"):
        scope = _FunctionScope()
        scope.visit(pf.tree)
        scope.close()

        # parent map for ancestor queries (return containment, assignment)
        parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(pf.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node

        def enclosing_function(node):
            cur = parents.get(node)
            while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cur = parents.get(cur)
            return cur

        def return_names(func) -> Set[str]:
            names: Set[str] = set()
            if func is None:
                return names
            for n in ast.walk(func):
                if isinstance(n, ast.Return) and n.value is not None:
                    for sub in ast.walk(n.value):
                        t = _terminal_name(sub)
                        if t:
                            names.add(t)
            return names

        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            is_thread = (isinstance(fn, ast.Attribute) and
                         fn.attr == "Thread" and
                         _terminal_name(fn.value) == "threading") or \
                        (isinstance(fn, ast.Name) and fn.id == "Thread")
            if not is_thread:
                continue
            daemon = False
            for kw in node.keywords:
                if kw.arg == "daemon" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value is True:
                    daemon = True
            if daemon:
                continue
            # ownership transfer: constructed inside a return statement
            cur, in_return = node, False
            while cur is not None:
                if isinstance(cur, ast.Return):
                    in_return = True
                    break
                cur = parents.get(cur)
            if in_return:
                continue
            # binding name: nearest Assign ancestor
            target_name = None
            cur = node
            while cur is not None:
                if isinstance(cur, ast.Assign):
                    for t in cur.targets:
                        target_name = _terminal_name(t) or target_name
                    break
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    break
                cur = parents.get(cur)
            ok = False
            if target_name:
                func = enclosing_function(node)
                rnames = return_names(func)
                if target_name in scope.join_names or \
                        target_name in scope.daemon_true_names or \
                        target_name in rnames:
                    ok = True
                else:
                    # appended onto a list that is joined or returned
                    for lst, item in scope.append_flows:
                        if item == target_name and (
                                lst in scope.join_names or lst in rnames):
                            ok = True
                            break
            if not ok:
                what = f"bound to {target_name!r}" if target_name \
                    else "unbound (fire-and-forget)"
                out.append(Finding(
                    "threads", pf.path, node.lineno,
                    f"non-daemon Thread {what} is neither joined nor "
                    f"returned to an owner — it can outlive shutdown"))
    return out


def _check_bare_except(tree: LintTree) -> List[Finding]:
    out: List[Finding] = []
    for pf in tree.code_files("bare-except"):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                out.append(Finding(
                    "bare-except", pf.path, node.lineno,
                    "bare 'except:' swallows SystemExit/KeyboardInterrupt "
                    "— catch Exception (or narrower)"))
    return out


_CHECK_FNS = {
    "hooks": _check_hooks,
    "metrics": _check_metrics,
    "conf": _check_conf,
    "wire-codes": _check_wire_codes,
    "threads": _check_threads,
    "bare-except": _check_bare_except,
}


# ---------------------------------------------------------------------------
# running the checks, and the baseline


def run_checks(root: str,
               checks: Optional[Iterable[str]] = None,
               paths: Optional[Iterable[str]] = None,
               docs: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run ``checks`` (default: all) over the tree at ``root`` (``paths`` and
    ``docs`` as :class:`LintTree`'s); returns suppression-filtered findings
    sorted by (path, line)."""
    tree = LintTree(root, paths=paths, docs=docs)
    selected = list(checks) if checks else list(ALL_CHECKS)
    unknown = [c for c in selected if c not in _CHECK_FNS]
    if unknown:
        raise ValueError(f"unknown checks: {', '.join(unknown)} "
                         f"(known: {', '.join(ALL_CHECKS)})")
    findings: List[Finding] = []
    for check in selected:
        findings.extend(_CHECK_FNS[check](tree))
    findings = [f for f in findings if not tree.suppressed(f)]
    findings.sort(key=lambda f: (f.path, f.line, f.check, f.message))
    return findings


def load_baseline(path: str) -> Set[str]:
    if not os.path.isfile(path):
        return set()
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    return set(doc.get("findings", []))


def load_reasons(path: str) -> Dict[str, str]:
    """The baseline's stated reason for each accepted fingerprint."""
    if not os.path.isfile(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    return dict(doc.get("reasons", {}))


def write_baseline(path: str, findings: Iterable[Finding],
                   reasons: Optional[Dict[str, str]] = None) -> None:
    """Accept ``findings``; ``reasons`` maps a fingerprint to why it is
    accepted (kept for the fingerprints still found)."""
    prints = sorted({f.fingerprint for f in findings})
    doc = {
        "comment": "accepted nnslint findings of the port, each with its reason; "
                   "regenerate with `python -m nnstreamer_tpu_torch.tools.nnslint "
                   "--write-baseline`",
        "findings": prints,
        "reasons": {fp: (reasons or {}).get(fp, "") for fp in prints},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def partition(findings: List[Finding],
              baseline: Set[str]) -> Tuple[List[Finding], Set[str]]:
    """Split into (new findings, resolved baseline fingerprints)."""
    current = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    resolved = baseline - current
    return new, resolved
