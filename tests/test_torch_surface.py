"""The port's public surface against the JAX package's.

Code written against ``waveform_ot_tpu`` should run on ``waveform_ot_torch``
once its import lines name the port. These tests hold the port to that by
reading both packages' sources with ``ast`` and importing each package once:

1. modules: every module of ``waveform_ot_tpu/`` has a counterpart at the
   same relative path in ``waveform_ot_torch/``;
2. names: every public module-level def, class and assignment has a
   counterpart of the same name;
3. class members: every public method, property and NamedTuple or
   dataclass field of every public class;
4. parameters: every parameter name of every public function and method;
5. package bindings: every name a package ``__init__`` binds is bound by the
   port's as the same kind (module, class or callable), read right after
   ``import waveform_ot_torch`` in a fresh interpreter;
6. command-line flags: the flags of each ``examples/<name>.py`` are among
   ``examples/torch_<name>.py``'s, and ``bench.py``'s among
   ``waveform_ot_torch/bench.py``'s;
7. entry points: ``__graft_entry__.py``'s public functions are in
   ``waveform_ot_torch/entry.py`` with their parameters.

The one list of exceptions is ``NOT_PORTED``: what the port leaves out or
renames by decision, the same entries as ROADMAP.md's "Not ported, by
decision". An entry that matches nothing fails, so the list cannot outlive
its reasons. Every case is an AST read or a dictionary lookup except the two
imports (a few seconds together).
"""

from __future__ import annotations

import ast
import functools
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = "waveform_ot_tpu", "waveform_ot_torch"


class NotPorted(NamedTuple):
    """One decision: the JAX side's ``jax`` (a regular expression over module
    paths, names or parameter names, by ``kind``) has ``port`` in its place
    in the port, or nothing (None), wherever ``where`` (a regular expression
    over "module" or "module:qualified name") matches."""

    kind: str           # "module", "name" or "param"
    jax: str
    port: str | None
    where: str
    why: str


NOT_PORTED = (
    NotPorted("module", "ops/ddfloat.py", None, ".*",
              "double-float32 arithmetic, for the TPU's missing float64: the H100 has native "
              "float64"),
    NotPorted("module", "ops/pallas_distance.py", "ops/cuda_distance.py", ".*",
              "the Pallas TPU kernel; the port's is CUDA C++ for sm_90a behind its own wrapper"),
    NotPorted("name", "CZ|cz_.*", None, "models/layered.py",
              "the layered code's complex numbers as (re, im) pairs of arrays or "
              "double-float32 values, and their helpers: the port uses native complex tensors"),
    NotPorted("param", "impl", None, ".*",
              "JAX's jnp/xla/pallas switch: the port runs the kernel or the plain field by the "
              "tensors' device"),
    NotPorted("param", "chunk", None, "ops/fingerprint.py:distance_field",
              "the segment chunk of the XLA scan, a TPU memory knob: the kernel plans its own "
              "split (cuda_distance.plan)"),
    NotPorted("param", "gather", None, "ops/wasser.py:wasserstein_1d_cost",
              "take or two one-hot MXU matmuls, the fast form on the TPU: the port gathers"),
    NotPorted("param", "z_loop", None, "inversion/loc_cmt.py:layered_misfit_grid",
              "lax.map over depths or an unroll, for XLA's compile: the port runs eagerly"),
    NotPorted("param", "jit", None, "inversion/trace.py:InversionTrace.wrap_objective",
              "jax.jit of the objective: torch has nothing to jit"),
    NotPorted("param", "jit_objective", None, "inversion/lbfgs.py:minimize_scipy",
              "jax.jit of the objective: torch has nothing to jit"),
    NotPorted("param", "m", "ms", ".*",
              "the port's objectives take a batch of models (k, nm) where JAX's take one and "
              "vmap"),
    NotPorted("param", "key", "generator", ".*",
              "random draws take a torch.Generator where JAX's take a PRNG key"),
    NotPorted("param", "per_item_fn", "fn", "parallel/mesh.py:sharded_(sum|map)",
              "the port's fn takes a slice of the batch, not JAX's one item: per_item_fn would "
              "promise semantics it does not have"),
)


def _decision(kind: str, name: str, where: str) -> NotPorted | None:
    for d in NOT_PORTED:
        if d.kind == kind and re.fullmatch(d.jax, name) and re.fullmatch(d.where, where):
            return d
    return None


# --- reading the sources ----------------------------------------------------------

def _modules(pkg: str) -> list[str]:
    """The package's modules as paths relative to it, builds left out."""
    base = ROOT / pkg
    return sorted(p.relative_to(base).as_posix() for p in base.rglob("*.py")
                  if "_build" not in p.parts)


@functools.cache
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _top(body):
    """Module-level statements, those under if/try blocks included."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top(node.body)
            yield from _top(node.orelse)
        elif isinstance(node, ast.Try):
            for block in (node.body, node.orelse, node.finalbody,
                          *(h.body for h in node.handlers)):
                yield from _top(block)
        else:
            yield node


def _assigned(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    out = []
    for t in targets:
        out += [e.id for e in ([t] if isinstance(t, ast.Name) else getattr(t, "elts", []))
                if isinstance(e, ast.Name)]
    return out


def _public_names(path: Path) -> dict[str, ast.AST]:
    """Public module-level defs, classes and assignments: {name: node}."""
    out = {}
    for node in _top(_tree(path).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(dict.fromkeys(_assigned(node), node))
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _is_public_member(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _members(path: Path, cls: ast.ClassDef) -> dict[str, ast.AST]:
    """A class's methods, properties and annotated fields, with those of its
    bases defined in the same module."""
    names = _public_names(path)
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name) and isinstance(names.get(base.id), ast.ClassDef):
            out.update(_members(path, names[base.id]))
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(dict.fromkeys(_assigned(node), node))
    return {k: v for k, v in out.items() if _is_public_member(k)}


def _params(fn) -> list[str]:
    a = fn.args
    out = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    out += [f"*{a.vararg.arg}"] if a.vararg else []
    out += [f"**{a.kwarg.arg}"] if a.kwarg else []
    return out


def _functions(path: Path) -> dict[str, ast.FunctionDef]:
    """Public functions and public methods of public classes: {qualified name: node}."""
    out = {}
    for name, node in _public_names(path).items():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[name] = node
        elif isinstance(node, ast.ClassDef):
            out.update({f"{name}.{m}": f for m, f in _members(path, node).items()
                        if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))})
    return out


def _missing_params(jax_fn, port_fn, where: str, used: set) -> list[str]:
    """The JAX function's parameters the port's lacks, decisions applied."""
    have, missing = _params(port_fn), []
    for p in _params(jax_fn):
        if p in have:
            continue
        d = _decision("param", p, where)
        if d is not None and (d.port is None or d.port in have):
            used.add(d)
        else:
            missing.append(p)
    return missing


# --- the checks ---------------------------------------------------------------------

JAX_MODULES = _modules(JAX)
COMPARED = [m for m in JAX_MODULES if _decision("module", m, m) is None]
CLASSES = [f"{m}::{n}" for m in COMPARED
           for n, node in _public_names(ROOT / JAX / m).items()
           if isinstance(node, ast.ClassDef) and _decision("name", n, m) is None]
PACKAGES = [JAX if m == "__init__.py" else f"{JAX}.{Path(m).parent.as_posix().replace('/', '.')}"
            for m in JAX_MODULES if Path(m).name == "__init__.py"]
EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*.py")
                  if not p.name.startswith("torch_"))
SCRIPTS = [(f"examples/{n}", f"examples/torch_{n}") for n in EXAMPLES] + [
    ("bench.py", f"{PORT}/bench.py")]


@functools.cache
def _surface() -> tuple[dict, set]:
    """Every static check's findings, {(check, case): [what is missing]}, and
    the decisions that excused something."""
    used: set = set()
    found: dict = {}
    for m in JAX_MODULES:
        d = _decision("module", m, m)
        if d is not None:
            if d.port is None or (ROOT / PORT / d.port).exists():
                used.add(d)
                continue
        found["modules", m] = [] if (ROOT / PORT / m).exists() else [m]
    for m in COMPARED:
        jpath, ppath = ROOT / JAX / m, ROOT / PORT / m
        if not ppath.exists():
            continue
        jn, pn = _public_names(jpath), _public_names(ppath)
        missing = []
        for name in jn:
            if name in pn:
                continue
            d = _decision("name", name, m)
            if d is None:
                missing.append(name)
            else:
                used.add(d)
        found["names", m] = missing
        for cname, node in jn.items():
            if f"{m}::{cname}" in CLASSES:
                other = pn.get(cname)
                have = _members(ppath, other) if isinstance(other, ast.ClassDef) else {}
                found["members", f"{m}::{cname}"] = [k for k in _members(jpath, node)
                                                     if k not in have]
        jf, pf = _functions(jpath), _functions(ppath)
        found["params", m] = [f"{q}({', '.join(miss)})" for q, f in jf.items() if q in pf
                              for miss in [_missing_params(f, pf[q], f"{m}:{q}", used)] if miss]
    return found, used


def _missing(check: str, case: str) -> list[str]:
    return _surface()[0].get((check, case), [])


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_has_counterpart(module):
    assert not _missing("modules", module), f"{PORT}/{module} is missing"


@pytest.mark.parametrize("module", COMPARED)
def test_public_names(module):
    assert not _missing("names", module), (
        f"{PORT}/{module} lacks the public names {_missing('names', module)}")


@pytest.mark.parametrize("cls", CLASSES)
def test_class_members(cls):
    assert not _missing("members", cls), (
        f"the port's {cls} lacks the members {_missing('members', cls)}")


@pytest.mark.parametrize("module", COMPARED)
def test_parameters(module):
    assert not _missing("params", module), (
        f"{PORT}/{module}: parameters missing from {_missing('params', module)}")


# --- what each package __init__ binds, by kind --------------------------------------

def _bound_by_init(pkg: str) -> list[str]:
    """Public names the package's ``__init__`` binds: its ``__all__`` if it has
    one, else its defs, classes and assignments and what it imports from the
    package itself."""
    path = ROOT / pkg.replace(".", "/") / "__init__.py"
    names = _public_names(path)
    if "__all__" in names:
        return list(ast.literal_eval(names["__all__"].value))
    out = list(names)
    for node in _top(_tree(path).body):
        if isinstance(node, ast.ImportFrom) and (node.level or node.module.startswith(JAX)):
            out += [a.asname or a.name for a in node.names]
    return [n for n in dict.fromkeys(out) if not n.startswith("_")]


_KINDS = """
import importlib, json, sys, types

def kind(obj):
    if isinstance(obj, types.ModuleType):
        return "module"
    if isinstance(obj, type):
        return "class"
    return "callable" if callable(obj) else "value"

importlib.import_module(sys.argv[1])   # the top package first, as a user imports it
out = {}
for pkg, names in json.loads(sys.argv[2]):
    mod = importlib.import_module(pkg)
    out[pkg] = {n: kind(getattr(mod, n)) if hasattr(mod, n) else "missing" for n in names}
print(json.dumps(out))
"""


@functools.cache
def _kinds() -> dict:
    """{package: {name: kind}} for every name a JAX package ``__init__`` binds,
    in both packages, each read in a fresh interpreter right after its top
    package is imported (the two interpreters run together)."""
    procs = {}
    for top in (JAX, PORT):
        request = [(top + p[len(JAX):], _bound_by_init(p)) for p in PACKAGES]
        procs[top] = subprocess.Popen([sys.executable, "-c", _KINDS, top, json.dumps(request)],
                                      cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)
    out = {}
    for top, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr
        out.update(json.loads(stdout.splitlines()[-1]))
    return out


@pytest.mark.parametrize("package", PACKAGES)
def test_package_bindings(package):
    port = PORT + package[len(JAX):]
    jax_kinds, port_kinds = _kinds()[package], _kinds()[port]
    wrong = {n: (k, port_kinds[n]) for n, k in jax_kinds.items() if port_kinds[n] != k}
    assert not wrong, f"{port}: (JAX kind, port kind) differ for {wrong}"


# --- command-line flags and entry points --------------------------------------------

def _flags(path: Path) -> set[str]:
    """The flags a script's argparse parser adds, and those it compares
    ``sys.argv`` entries with."""
    out = set()
    for node in ast.walk(_tree(path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant) and str(a.value).startswith("-")}
        elif isinstance(node, ast.Compare):
            out |= {c.value for c in node.comparators
                    if isinstance(c, ast.Constant) and str(c.value).startswith("--")}
    return out


@pytest.mark.parametrize("script,port_script", SCRIPTS, ids=[s for s, _ in SCRIPTS])
def test_cli_flags(script, port_script):
    assert (ROOT / port_script).exists(), f"{port_script} is missing"
    missing = _flags(ROOT / script) - _flags(ROOT / port_script)
    assert not missing, f"{port_script} lacks {script}'s flags {sorted(missing)}"


ENTRY_NAMES = [n for n, node in _public_names(ROOT / "__graft_entry__.py").items()
               if isinstance(node, ast.FunctionDef)]


@pytest.mark.parametrize("name", ENTRY_NAMES)
def test_entry_point(name):
    port = _public_names(ROOT / PORT / "entry.py")
    assert isinstance(port.get(name), ast.FunctionDef), f"{PORT}/entry.py has no {name}()"
    missing = _missing_params(_public_names(ROOT / "__graft_entry__.py")[name], port[name],
                              f"entry.py:{name}", set())
    assert not missing, f"{PORT}/entry.py: {name}() lacks the parameters {missing}"


# --- the exceptions ------------------------------------------------------------------

@pytest.mark.parametrize("decision", NOT_PORTED, ids=[f"{d.kind}:{d.jax}" for d in NOT_PORTED])
def test_not_ported_entry_is_used(decision):
    """Each decision excuses something the JAX package still has."""
    assert decision in _surface()[1], f"nothing in {JAX} matches {decision}"
