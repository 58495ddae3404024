"""Path-addressable tree utilities (dict trees only, which is all we use);
a copy of ``repro.utils.trees``.  ``Model`` registers its parameters under
these paths, with ``/`` read as ``.``."""
from __future__ import annotations

from typing import Any, Dict


def tree_paths(tree) -> Dict[str, Any]:
    """Flatten a nested-dict tree to {'a/b/c': leaf}."""
    flat: Dict[str, Any] = {}

    def walk(prefix: str, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def tree_from_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild a nested-dict tree from {'a/b/c': leaf}."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root
