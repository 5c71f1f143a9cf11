"""Trees of tensors: nested dicts, lists and tuples (NamedTuples too).

The port's params, grads and optimizer states are such trees.  They
flatten in JAX's order: a dict by its sorted keys, a list or tuple in
order, ``None`` as an empty node.  So a tree of the same nesting as a JAX
pytree yields its leaves in the same order, which is what lets the
checkpoint files of both packages line up.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple

# a TreeDef is ("leaf",), ("none",), ("dict", keys, children),
# ("list", None, children) or ("tuple", type, children)
TreeDef = Tuple
_END = object()


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    out: List[Any] = []

    def walk(node) -> TreeDef:
        if node is None:
            return ("none",)
        if isinstance(node, Mapping):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, list):
            return ("list", None, tuple(walk(c) for c in node))
        if isinstance(node, tuple):
            return ("tuple", type(node), tuple(walk(c) for c in node))
        out.append(node)
        return ("leaf",)

    treedef = walk(tree)
    return out, treedef


def unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d: TreeDef):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        children = [build(c) for c in d[2]]
        if kind == "dict":
            return dict(zip(d[1], children))
        if kind == "list":
            return children
        return d[1](*children) if hasattr(d[1], "_fields") else tuple(
            children)

    tree = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return tree


def flatten_up_to(treedef: TreeDef, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaves of ``treedef`` (an optimizer
    state's ``Quantized`` moments stay whole)."""
    out: List[Any] = []

    def walk(d: TreeDef, node):
        kind = d[0]
        if kind == "leaf":
            out.append(node)
        elif kind == "dict":
            for k, c in zip(d[1], d[2]):
                walk(c, node[k])
        elif kind != "none":
            if len(node) != len(d[2]):
                raise ValueError(f"{len(node)} children where the tree has "
                                 f"{len(d[2])}")
            for c, n in zip(d[2], node):
                walk(c, n)

    walk(treedef, tree)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``."""
    leaves, treedef = flatten(tree)
    others = [flatten_up_to(treedef, r) for r in rest]
    return unflatten(treedef, [fn(*args) for args in zip(leaves, *others)])


def flatten_with_path(tree: Any) -> List[Tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf in :func:`flatten`'s order.  A path
    is the tuple of keys from the root: a dict's key, a list's or a plain
    tuple's index, a NamedTuple's field name."""
    out: List[Tuple[tuple, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            names = getattr(node, "_fields", range(len(node)))
            for k, c in zip(names, node):
                walk(c, path + (k,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def tree_map_with_path(fn: Callable[[tuple, Any], Any], tree: Any) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, in its structure."""
    treedef = flatten(tree)[1]
    return unflatten(treedef, [fn(p, l) for p, l in flatten_with_path(tree)])


def describe(treedef: TreeDef) -> str:
    """A readable form of ``treedef`` (the checkpoint manifest's
    ``treedef``)."""
    kind = treedef[0]
    if kind in ("leaf", "none"):
        return "*" if kind == "leaf" else "None"
    inner = [describe(c) for c in treedef[2]]
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {v}" for k, v in
                               zip(treedef[1], inner)) + "}"
    if kind == "list":
        return "[" + ", ".join(inner) + "]"
    return f"{treedef[1].__name__}(" + ", ".join(inner) + ")"
