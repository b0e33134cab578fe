"""States are trees of NamedTuples with tensor leaves; the program and
the reference name their fields alike."""

from __future__ import annotations

import importlib

import torch


def tree_map(fn, tree):
    """fn on every tensor leaf; other leaves (None, numbers) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return tree


def leaves(tree, prefix=""):
    """(dotted name, tensor) of every tensor leaf."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from leaves(v, f"{prefix}.{k}" if prefix else k)


def copy_into(dst, src) -> None:
    """Copy every tensor of src into the same-shaped tensor of dst."""
    for (_, d), (_, s) in zip(leaves(dst), leaves(src)):
        d.copy_(s)


def to_host(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def rebuild(tree, pkg: str, device):
    """The tree with every NamedTuple replaced by the class of the same
    name in the same module of package `pkg` (the program's state as the
    reference's), its tensors copied to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if hasattr(tree, "_fields"):
        cls = type(tree)
        mod = cls.__module__.split(".", 1)
        target = getattr(importlib.import_module(
            pkg + ("." + mod[1] if len(mod) > 1 else "")), cls.__name__)
        return target(*(rebuild(v, pkg, device) for v in tree))
    return tree
