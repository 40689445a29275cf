"""Hot-reloadable kernel registry.

Reference: src/dx/dx_pipeline.h:432-469 — pipelines register by shader
filename; a file watcher recompiles changed shaders and swaps the PSO in
place (dx_pipeline.cpp:412,468).  Equivalent here: jitted functions register
by source module; when the watcher reports a change, the module reloads and
the jit cache entry is invalidated, so the next call traces the new code.
"""

from __future__ import annotations

import importlib
import os
import sys
import types
from typing import Callable, Dict, Optional

import jax

from ..assets.cache import FileRegistry
from ..core.log import log_info


class KernelRegistry:
    """Named jitted entry points with source-file invalidation."""

    def __init__(self):
        self._entries: Dict[str, dict] = {}

    def register(self, name: str, module_name: str, attr: str,
                 static_argnums=(), jit_kwargs: Optional[dict] = None):
        """Register `module.attr` as kernel `name` (jitted lazily)."""
        self._entries[name] = {
            "module": module_name, "attr": attr,
            "static_argnums": static_argnums,
            "jit_kwargs": jit_kwargs or {},
            "compiled": None,
            "version": 0,
        }

    def get(self, name: str) -> Callable:
        e = self._entries[name]
        if e["compiled"] is None:
            mod = importlib.import_module(e["module"])
            fn = getattr(mod, e["attr"])
            e["compiled"] = jax.jit(fn, static_argnums=e["static_argnums"],
                                    **e["jit_kwargs"])
        return e["compiled"]

    def __call__(self, name: str, *args, **kw):
        return self.get(name)(*args, **kw)

    def invalidate_module(self, module_name: str):
        """Reload the module and drop compiled entries referencing it
        (the PSO-swap equivalent, dx_pipeline.cpp:468)."""
        if module_name in sys.modules:
            importlib.reload(sys.modules[module_name])
        n = 0
        for name, e in self._entries.items():
            if e["module"] == module_name:
                e["compiled"] = None
                e["version"] += 1
                n += 1
        if n:
            log_info("hot-reloaded %s (%d kernels invalidated)",
                     module_name, n)
        return n

    def version(self, name: str) -> int:
        return self._entries[name]["version"]

    def watch(self, registry: FileRegistry, source_root: str,
              package_prefix: str):
        """Wire a FileRegistry watcher: .py changes under `source_root`
        reload the corresponding module."""
        root = os.path.abspath(source_root)

        def on_change(kind: str, rel: str):
            if kind != "modified" or not rel.endswith(".py"):
                return
            mod = package_prefix + "." + rel[:-3].replace(os.sep, ".")
            mod = mod.replace(".__init__", "")
            if mod in sys.modules:
                self.invalidate_module(mod)

        registry.on_change(on_change)


# A process-wide default registry, like the reference's global pipeline list.
kernels = KernelRegistry()
