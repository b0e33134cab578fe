"""lax.cond and lax.while_loop for the eager step: each predicate is
read on the host (a sync), as the program's step does outside a CUDA
graph capture."""

import torch


def capturing() -> bool:
    return False


def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return tree


def while_loop(cond_fn, body_fn, carry):
    """carry = body_fn(carry) while cond_fn(carry)."""
    while bool(cond_fn(carry)):
        carry = body_fn(carry)
    return carry


def cond(pred, true_fn, carry):
    """true_fn(carry) if pred, else carry."""
    return true_fn(carry) if bool(pred) else carry
