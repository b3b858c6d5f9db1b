"""The port's import layering, read from the source (no module is imported).

The peel core (``src/repro_torch/core``) imports one way: ``peelspec``
and ``graph`` below the engines' structures, the FD packers below the
engines, the engines below the distributed peel.  A function-level
import counts like a module-level one: it hides a cycle from the
interpreter, not from the reader.
"""
import ast
import pathlib

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CORE = "repro_torch.core"


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(PKG.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imports(path: pathlib.Path):
    """(module imported, names taken from it) for every import statement
    of ``path``, at any depth, relative imports resolved."""
    name = _module_name(path)
    package = name if path.name == "__init__.py" else name.rpartition(".")[0]
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, ()
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")
                base = base[:len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod, tuple(a.name for a in node.names)


def _core_graph() -> dict:
    """module -> the set of ``repro_torch.core`` modules it imports."""
    mods = {_module_name(p): p for p in (PKG / "core").glob("*.py")}
    graph = {}
    for mod, path in mods.items():
        deps = set()
        for target, names in _imports(path):
            if target in mods:
                deps.add(target)
            # ``from . import csr`` names a submodule
            deps.update(f"{target}.{n}" for n in names
                        if f"{target}.{n}" in mods)
        deps.discard(mod)
        deps.discard(CORE)
        graph[mod] = deps
    return graph


def _find_cycle(graph: dict):
    """One import cycle of ``graph`` as a list of modules, or None."""
    state, stack = {}, []

    def visit(node):
        state[node] = "open"
        stack.append(node)
        for nxt in sorted(graph.get(node, ())):
            if state.get(nxt) == "open":
                return stack[stack.index(nxt):] + [nxt]
            if nxt not in state:
                found = visit(nxt)
                if found:
                    return found
        stack.pop()
        state[node] = "done"
        return None

    for node in sorted(graph):
        if node not in state:
            found = visit(node)
            if found:
                return found
    return None


def test_core_modules_import_without_a_cycle():
    graph = _core_graph()
    assert f"{CORE}.csr" in graph[f"{CORE}.peel"]   # the scan sees imports
    cycle = _find_cycle(graph)
    assert cycle is None, "import cycle: " + " -> ".join(cycle)
    assert f"{CORE}.distributed" not in graph[f"{CORE}.peel"]


def test_resolve_device_comes_from_the_device_module():
    """Checking a device name does not import the peel."""
    wrong = []
    for path in sorted(PKG.rglob("*.py")):
        for target, names in _imports(path):
            if "resolve_device" in names and target != "repro_torch.device":
                wrong.append(f"{path.relative_to(PKG)}: from {target}")
    assert not wrong, wrong
