"""Helpers of the port's run loop, and its pytree helpers for blobs.

The counterpart of ``emcee_tpu/utils.py:27-69`` (``defer_interrupts``).
The walker-initialisation helpers and ``find_map`` of that module are not
ported yet (ROADMAP P12).

A blob is a pytree whose leaves carry the walker axis first: a tensor (or
numpy array), or a tuple, list or dict of blobs.  :func:`tree_flatten`,
:func:`tree_unflatten`, :func:`tree_leaves` and :func:`tree_map` walk
it in the order of ``jax.tree_util``: sequences in order, **dicts by
sorted key**, ``None`` an empty node.  Declared ``blobs_dtype`` fields and
the HDF field names follow that leaf order, so a different order would
put values under the wrong names.
"""

from __future__ import annotations

import contextlib
import signal
import threading

__all__ = ["defer_interrupts", "tree_flatten", "tree_leaves", "tree_map",
           "tree_unflatten"]


@contextlib.contextmanager
def defer_interrupts():
    """Hold SIGINT while a chunk is written to the backend and the resume
    anchors move to it, so that a Ctrl-C never lands between the two
    (which would leave the backend one chunk ahead of the anchors, and
    ``run_mcmc(None, n)`` would store that chunk twice).

    A held interrupt is delivered again through the restored handler
    when the block ends cleanly (``signal.raise_signal``), so a process
    that ignores SIGINT or installed its own handler keeps its
    behaviour.  If the block itself raised, the held interrupt is
    dropped so it cannot mask that exception.  Off the main thread
    (signal handlers are the main thread's) and under a handler not
    installed from Python, the block runs undeferred.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = signal.getsignal(signal.SIGINT)
    if prev is None:  # a handler not installed from Python
        yield
        return
    held = []
    try:
        signal.signal(signal.SIGINT, lambda sig, frame: held.append(sig))
    except ValueError:  # an embedding that refuses the handler
        yield
        return
    body_raised = False
    try:
        yield
    except BaseException:
        body_raised = True
        raise
    finally:
        signal.signal(signal.SIGINT, prev)
        if held and not body_raised:
            signal.raise_signal(signal.SIGINT)


def _flatten_into(tree, leaves):
    """The treedef of ``tree``; its leaves are appended to ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys,
                tuple(_flatten_into(tree[k], leaves) for k in keys))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten_into(c, leaves) for c in tree))
    leaves.append(tree)
    return "*"


def _build(treedef, leaves):
    """The tree of ``treedef`` from the iterator ``leaves``."""
    if treedef is None:
        return None
    if treedef == "*":
        return next(leaves)
    if treedef[0] == "dict":
        return {k: _build(c, leaves) for k, c in zip(treedef[1], treedef[2])}
    kind, children = treedef
    values = [_build(c, leaves) for c in children]
    if kind is tuple or kind is list:
        return kind(values)
    return kind(*values)  # a namedtuple


def tree_flatten(tree):
    """``(leaves, treedef)`` of a blob pytree; ``treedef`` is a hashable
    description that :func:`tree_unflatten` rebuilds the tree from, and
    two trees of one structure have equal treedefs.  (Module-level
    recursion, not closures: a call leaves no reference cycle for the
    garbage collector, which may run while a CUDA graph records.)"""
    leaves = []
    return leaves, _flatten_into(tree, leaves)


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` (from :func:`tree_flatten`) with
    ``leaves`` in its leaf order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places for")
    return out


def tree_leaves(tree):
    """The leaves of a blob pytree, in ``jax.tree_util`` order."""
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of ``rest``,
    which must have its structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        rl, rd = tree_flatten(r)
        if rd != treedef:
            raise ValueError("tree_map over trees of different structure")
        others.append(rl)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
