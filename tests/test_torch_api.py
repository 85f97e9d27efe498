"""The port's public API covers the JAX package's, name by name.

For every module of ``tnco_tpu/`` the test parses it and its counterpart
in ``tnco_tpu_torch/`` with :mod:`ast` (neither package is imported) and
asserts that

- each public top-level name and each ``__all__`` entry is bound in the
  port's module (defined, assigned or imported there);
- each public method of each public class exists on the port's class
  (defined in its body, assigned there, or inherited from a port base);
- each parameter name of each public function and method, and of each
  public class's constructor, exists in the port's signature (a
  ``**kwargs`` does not count).

A gap is allowed only through :data:`DELIBERATE`, which gives each its
reason and the phrase of ``ROADMAP.md``'s queue 3 (the deliberate
differences) that records it.  An entry that matches no gap fails too,
so the table cannot go stale.
"""

import ast
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[1]
_REF, _PORT = _ROOT / 'tnco_tpu', _ROOT / 'tnco_tpu_torch'
# The port's own module names for the Pallas kernel modules.
RENAMED = {'kernels/pallas_gather.py': 'kernels/gather.py',
           'kernels/pallas_scatter.py': 'kernels/scatter.py',
           'kernels/pallas_walker.py': 'kernels/walker.py'}
MODULES = sorted(p.relative_to(_REF).as_posix() for p in _REF.rglob('*.py'))


def _each(keys, reason, roadmap):
    return {k: (reason, roadmap) for k in keys}


# Key forms: 'module::name', 'module::Class.method',
# 'module::function(param)', 'module::Class.method(param)' and
# 'module::Class(param)' (a constructor parameter).  Value: (the reason,
# a phrase of ROADMAP.md's queue 3 that records the difference).
DELIBERATE = {
    **_each([f'{m}::{f}(interpret)' for m, f in (
        ('kernels/pallas_gather.py', 'gather_gbn'),
        ('kernels/pallas_gather.py', 'gather_bn'),
        ('kernels/pallas_scatter.py', 'inv_ids'),
        ('kernels/pallas_scatter.py', 'scatter_rows_gbn'),
        ('kernels/pallas_scatter.py', 'scatter_rows_inplace'),
        ('kernels/pallas_walker.py', 'run_walker'),
        ('kernels/pallas_walker.py', 'run_walker_fw'),
        ('kernels/sa_fullsweep.py', 'run_fullsweep'),
        ('kernels/sa_fullsweep.py', 'run_fullsweep_fw'),
        ('kernels/sa_walks.py', 'run_walks'),
        ('kernels/sa_walks.py', 'run_walks_fw'))],
            'Pallas interpret mode: a port wrapper runs its plain version '
            'on a CPU tensor and its kernel on a CUDA one',
            'No Pallas `interpret=`'),
    **_each([f'{m}::{c}.{f}' for m, c in (
        ('kernels/sa_batched.py', 'SABatch'),
        ('kernels/sa_finite_batched.py', 'SABatchFW'),
        ('kernels/sa_infinite.py', 'SAStateIM'),
        ('kernels/sa_finite.py', 'SAStateFW'))
        for f in ('tree_flatten', 'tree_unflatten')],
            "JAX pytree registration; the port's states are dataclasses "
            'of tensors', 'No pytree `tree_flatten`/`tree_unflatten`'),
    **_each(['kernels/pallas_gather.py::gather_supported',
             'kernels/pallas_scatter.py::scatter_supported'],
            "the TPU kernels' block-shape gates; the CUDA kernels take "
            'every shape', 'No `gather_supported`/`scatter_supported`'),
    **_each(['kernels/pallas_walker.py::run_walker_sharded',
             'kernels/sa_walks.py::run_walks_sharded'],
            "SPMD ranks: on a mesh the runners call run_walker(_fw) and "
            "run_walks(_fw) on the rank's block",
            'No function-level `run_walks_sharded` / `run_walker_sharded`'),
    **_each(['optimize/infinite_memory/optimizer.py::key_to_state',
             'optimize/infinite_memory/optimizer.py::state_to_key'],
            "JAX PRNG keys; the port's prng_state is a torch.Generator "
            "state ('torchgen:')", 'No `key_to_state`/`state_to_key`'),
    'kernels/sa_finite.py::greedy_slices(key)': (
        "the draws rule: the slicer takes its jitter drawn, not a JAX key",
        '`sa_finite.greedy_slices` takes `jitter`, not `key`'),
}


def _queue3():
    """The text of ROADMAP.md's queue 3 (the section headed ``### 3.``)."""
    text = (_ROOT / 'ROADMAP.md').read_text()
    start = text.index('\n### 3.')
    end = text.find('\n## ', start)
    return text[start:end if end >= 0 else None]


def _bindings(body):
    """The top-level statements of ``body``, into ``if``/``try``/``with``
    blocks (not into functions or classes)."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ('body', 'orelse', 'finalbody'):
                yield from _bindings(getattr(node, field, []))
            for h in getattr(node, 'handlers', []):
                yield from _bindings(h.body)
        else:
            yield node


def _targets(node):
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    else:
        return []
    out = []
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.append(n.id)
    return out


class _Module:
    """What a module binds at top level, parsed from its source."""

    def __init__(self, root, rel, package):
        self.rel, self.package = rel, package
        self.path = root / rel
        self.defs, self.aliases, self.imports = {}, {}, {}
        self.names, self.all, self.modules = set(), [], set()
        tree = ast.parse(self.path.read_text())
        for node in _bindings(tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self.defs[node.name] = node
                self.names.add(node.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.names.add(a.asname or a.name.split('.')[0])
                    self.modules.add(a.asname or a.name.split('.')[0])
            elif isinstance(node, ast.ImportFrom):
                src = self._resolve(node)
                for a in node.names:
                    self.names.add(a.asname or a.name)
                    self.imports[a.asname or a.name] = (src, a.name)
            else:
                for name in _targets(node):
                    self.names.add(name)
                    if name == '__all__' and isinstance(
                            node.value, (ast.List, ast.Tuple)):
                        self.all += [e.value for e in node.value.elts]
                    elif isinstance(node, ast.Assign) and isinstance(
                            node.value, ast.Name):
                        self.aliases[name] = node.value.id

    def _resolve(self, node):
        """The dotted module of an ``ImportFrom``."""
        if not node.level:
            return node.module or ''
        parts = (self.package + '/' + self.rel).split('/')[:-1]
        parts = parts[:len(parts) - node.level + 1]
        return '.'.join(parts + ([node.module] if node.module else []))

    def public(self):
        """Public top-level names: defined or assigned here, listed in
        ``__all__``, or (in a package's ``__init__``) imported from the
        package."""
        out = {n for n in self.names
               if not n.startswith('_') and n not in self.imports and
               n not in self.modules}
        if self.rel.endswith('__init__.py'):
            out |= {n for n, (src, _) in self.imports.items()
                    if src.split('.')[0] == self.package and
                    not n.startswith('_')}
        return out | set(self.all)


_CACHE = {}


def _module(package, dotted_or_rel):
    """A parsed module of ``package`` by its dotted name or its path
    relative to the package root; None if there is none."""
    root = _REF if package == 'tnco_tpu' else _PORT
    rel = dotted_or_rel
    if not rel.endswith('.py'):
        parts = rel.split('.')[1:]
        cand = '/'.join(parts) + '.py'
        rel = cand if (root / cand).exists() else '/'.join(
            parts + ['__init__.py'])
    key = (package, rel)
    if key not in _CACHE:
        _CACHE[key] = (_Module(root, rel, package)
                       if (root / rel).exists() else None)
    return _CACHE[key]


def _find(mod, name, depth=0):
    """``(module, node)`` of the definition ``name`` is bound to in
    ``mod``, following imports and ``x = y`` aliases; node None where the
    binding is not a def or class (an assignment of another kind)."""
    if mod is None or depth > 8:
        return None
    if mod.rel.endswith('__init__.py'):
        pkg = mod.path.parent
        if (pkg / f'{name}.py').exists() or (pkg / name / '__init__.py'
                                              ).exists():
            return mod, None                            # a submodule
    if name in mod.defs:
        return mod, mod.defs[name]
    if name in mod.aliases:
        return _find(mod, mod.aliases[name], depth + 1)
    if name in mod.imports:
        src, orig = mod.imports[name]
        if src.split('.')[0] == mod.package:
            return _find(_module(mod.package, src), orig, depth + 1)
    return (mod, None) if name in mod.names else None


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ('self', 'cls')]


def _is_dataclass(cls):
    for d in cls.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        if (isinstance(d, ast.Name) and d.id == 'dataclass') or (
                isinstance(d, ast.Attribute) and d.attr == 'dataclass'):
            return True
    return False


def _fields(cls):
    return [s.target.id for s in cls.body
            if isinstance(s, ast.AnnAssign) and
            isinstance(s.target, ast.Name)]


def _members(mod, cls, depth=0):
    """``{name: FunctionDef or None}`` of a class's body and its bases
    (bases first, so the class's own entries win)."""
    out = {}
    if depth > 8:
        return out
    for base in cls.bases:
        if isinstance(base, ast.Name):
            found = _find(mod, base.id)
            if found and isinstance(found[1], ast.ClassDef):
                out.update(_members(found[0], found[1], depth + 1))
                continue
        if isinstance(base, ast.Name) and base.id == 'NamedTuple':
            out['_fields'] = None
    for s in cls.body:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[s.name] = s
        else:
            for name in _targets(s):
                out[name] = _alias_target(mod, s) if isinstance(
                    s, ast.Assign) else None
    return out


def _alias_target(mod, assign):
    """A class attribute ``m = Base.m`` as ``Base.m``'s FunctionDef (its
    signature), else None."""
    v = assign.value
    if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name):
        found = _find(mod, v.value.id)
        if found and isinstance(found[1], ast.ClassDef):
            return _members(found[0], found[1]).get(v.attr)
    return None


def _ctor(mod, cls, depth=0):
    """A class's constructor parameters: its ``__init__``'s, else its
    dataclass or NamedTuple fields (bases first), else a base's."""
    for s in cls.body:
        if isinstance(s, ast.FunctionDef) and s.name == '__init__':
            return _params(s)
    fields = []
    if depth > 8:
        return fields
    for base in cls.bases:
        if isinstance(base, ast.Name):
            found = _find(mod, base.id)
            if found and isinstance(found[1], ast.ClassDef):
                fields += _ctor(found[0], found[1], depth + 1)
    named = any(isinstance(b, ast.Name) and b.id == 'NamedTuple'
                for b in cls.bases)
    if _is_dataclass(cls) or named:
        fields += _fields(cls)
    return fields


def port_module(rel):
    """The port's counterpart of the JAX package's module ``rel``."""
    return _module('tnco_tpu_torch', RENAMED.get(rel, rel))


def gaps(rel):
    """Every name, method and parameter of ``tnco_tpu/<rel>`` without a
    counterpart in the port, as :data:`DELIBERATE` keys."""
    ref = _module('tnco_tpu', rel)
    port = port_module(rel)
    if port is None:
        return {f'{rel}::<module>'}
    out = set()
    for name in sorted(ref.public()):
        found = _find(port, name)
        if found is None:
            out.add(f'{rel}::{name}')
            continue
        node = ref.defs.get(name)
        pmod, pnode = found
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(pnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
                have = set(_params(pnode))
                out |= {f'{rel}::{name}({p})' for p in _params(node)
                        if p not in have}
        elif isinstance(node, ast.ClassDef) and isinstance(pnode,
                                                           ast.ClassDef):
            have = set(_ctor(pmod, pnode))
            out |= {f'{rel}::{name}({p})' for p in _ctor(ref, node)
                    if p not in have}
            members = _members(pmod, pnode)
            for m, fn in _members(ref, node).items():
                if m.startswith('_') or fn is None:
                    continue
                if m not in members:
                    out.add(f'{rel}::{name}.{m}')
                elif members[m] is not None:
                    have = set(_params(members[m]))
                    out |= {f'{rel}::{name}.{m}({p})' for p in _params(fn)
                            if p not in have}
    return out


@pytest.mark.parametrize('rel', MODULES)
def test_port_covers_reference_module(rel):
    """Every gap of the module is in DELIBERATE, and every DELIBERATE
    entry of the module is a gap."""
    found = gaps(rel)
    listed = {k for k in DELIBERATE if k.split('::')[0] == rel}
    assert not found - listed, sorted(found - listed)
    assert not listed - found, ('stale DELIBERATE entries',
                                sorted(listed - found))


def test_deliberate_entries_are_recorded():
    """Each DELIBERATE entry names a module of the JAX package, gives a
    reason, and points at a phrase that ROADMAP.md's queue 3 holds."""
    queue3 = _queue3()
    for key, (reason, roadmap) in DELIBERATE.items():
        assert key.split('::')[0] in MODULES, key
        assert reason and roadmap in queue3, (key, roadmap)
