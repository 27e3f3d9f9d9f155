"""Start-up hook for interpreters run with ``PYTHONPATH=src``.

The reference package (``src/repro``) imports ``enable_x64`` from
``jax.experimental``; JAX 0.9 moved it to ``jax.enable_x64`` and left the
old name raising.  The repository's ``conftest.py`` restores the old name
inside pytest; this hook does the same for every other interpreter started
with ``src`` on its path (``python -c`` subprocesses of the tests, scripts).

It is lazy: Python imports this module at start-up, and it only adds an
import hook.  Nothing of JAX is imported here; the alias is set when
``jax.experimental`` is imported, right after its own code has run, and
only if that JAX lacks the name.
"""
import importlib.abc
import sys

_TARGET = "jax.experimental"


class _AliasingLoader(importlib.abc.Loader):
    """Runs the real loader, then sets the alias on the new module."""

    def __init__(self, loader):
        self._loader = loader

    def create_module(self, spec):
        return self._loader.create_module(spec)

    def exec_module(self, module):
        self._loader.exec_module(module)
        jax = sys.modules.get("jax")
        if "enable_x64" not in vars(module) and hasattr(jax, "enable_x64"):
            module.enable_x64 = jax.enable_x64


class _EnableX64Finder(importlib.abc.MetaPathFinder):
    """Finds ``jax.experimental`` through the other finders and wraps its
    loader; every other import passes by."""

    def find_spec(self, fullname, path, target=None):
        if fullname != _TARGET:
            return None
        for finder in sys.meta_path:
            if finder is self or not hasattr(finder, "find_spec"):
                continue
            spec = finder.find_spec(fullname, path, target)
            if spec is not None:
                if spec.loader is not None and hasattr(spec.loader, "exec_module"):
                    spec.loader = _AliasingLoader(spec.loader)
                return spec
        return None


if not any(isinstance(f, _EnableX64Finder) for f in sys.meta_path):
    sys.meta_path.insert(0, _EnableX64Finder())
