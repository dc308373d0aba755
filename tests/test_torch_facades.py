"""The port's package facades export what the reference's export.

For ``repro/api.py`` and every reference package ``__init__`` with an
``__all__``, the names are read with ``ast`` (nothing of the reference is
imported), each traced to the reference module that defines it.  A name
whose defining module has a port counterpart (``repro.x.y`` ->
``repro_torch.x.y``) that defines it must import from the port's matching
package, and stand in that package's ``__all__`` in the reference's
order.  The names whose modules are not ported yet are listed below; the
test fails when one of them turns out to be ported, so the list shrinks
as the port grows.
"""
import ast
import importlib
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF_EXPORTS = sorted([SRC / "repro" / "api.py"]
                     + [p for p in (SRC / "repro").glob("*/__init__.py")
                        if "__all__" in p.read_text()])

# exporting reference module -> the names it exports whose defining
# modules are not ported yet (none left: the sharding rule table of
# distributed/sharding.py was the last)
WAITING = {}


def _exports(path: pathlib.Path):
    """(module name, __all__, {name: defining module}) of one reference file."""
    module = ".".join(path.relative_to(SRC).with_suffix("").parts)
    module = module.removesuffix(".__init__")
    package = module if path.name == "__init__.py" else module.rsplit(".", 1)[0]
    names, origin = None, {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names = ast.literal_eval(node.value)
        elif isinstance(node, ast.ImportFrom):
            source = node.module or ""
            if node.level:   # relative import inside the package
                base = package.split(".")[: len(package.split(".")) - node.level + 1]
                source = ".".join(base + ([source] if source else []))
            for alias in node.names:
                origin[alias.asname or alias.name] = source
    return module, names, origin


def _port(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def _port_defines(module: str, name: str) -> bool:
    try:
        return hasattr(importlib.import_module(_port(module)), name)
    except ImportError:
        return False


@pytest.mark.parametrize("path", REF_EXPORTS,
                         ids=lambda p: str(p.relative_to(SRC)))
def test_port_package_exports_every_ported_reference_name(path):
    module, names, origin = _exports(path)
    ported = [n for n in names if _port_defines(origin.get(n, module), n)]
    waiting = [n for n in names if n not in ported]
    assert sorted(waiting) == sorted(WAITING.get(module, [])), (
        "a waiting name is ported (take it off WAITING and export it), or a "
        "ported name lost its definition")
    if not ported:
        return
    package = importlib.import_module(_port(module))
    missing = [n for n in ported if not hasattr(package, n)]
    assert not missing, f"{_port(module)} does not export {missing}"
    in_all = [n for n in package.__all__ if n in ported]
    assert in_all == ported, f"{_port(module)}.__all__ lacks or reorders names"


def test_every_reference_facade_is_checked():
    modules = {_exports(p)[0] for p in REF_EXPORTS}
    assert {"repro.api", "repro.obs", "repro.serve", "repro.plan"} <= modules
    assert set(WAITING) <= modules
