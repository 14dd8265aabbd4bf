# -*- coding: utf-8 -*-
"""Checkpoint / resume for sampler and model state.

The unit of persistence is a tree (dicts, lists, tuples, named tuples) of
arrays: parameter vectors, chain states, adaptation state, generator
states.  Factorized solver state is left out: it is recomputable from the
parameters and the data.  The format is the JAX package's pickle of numpy
arrays (its ``.pkl`` path): tensors go to numpy on save and come back as
tensors on the caller's device on restore, and a ``.pkl`` written by the
JAX package restores here.
"""

import os
import pickle

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["save_checkpoint", "restore_checkpoint", "sampler_state"]


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(fn, tree):
    """Apply ``fn`` to every leaf, keeping the containers."""
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _leaves(tree):
    """The leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if tree is None:
        return []
    return [tree]


def _unflatten(target, leaves):
    """``target``'s containers filled with ``leaves`` in order."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            filled = {k: fill(t[k]) for k in sorted(t)}
            return type(t)((k, filled[k]) for k in t)
        if _is_namedtuple(t):
            return type(t)(*(fill(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        if t is None:
            return None
        return next(it)

    return fill(target)


def _to_host(leaf):
    if isinstance(leaf, torch.Generator):
        leaf = leaf.get_state()
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path, state):
    """Persist a tree of arrays / tensors to ``path`` (a ``.pkl`` file; any
    other path gets ``.pkl`` appended, as the JAX package's fallback
    does).  Returns the file written."""
    state = _map(_to_host, state)
    if not path.endswith(".pkl"):
        path = path + ".pkl"
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=-1)
    return path


def restore_checkpoint(path, target=None, device=None):
    """Restore a tree saved by :func:`save_checkpoint` (or by the JAX
    package's), every array a tensor on ``device``.

    ``target`` (optional) is a prototype tree whose containers (e.g. named
    tuples) the leaves are put back into, in order.  ``device`` defaults to
    that of ``target``'s first tensor, else the CUDA card (raising without
    one, as every entry point does).
    """
    real = path if path.endswith(".pkl") else path + ".pkl"
    if not os.path.isfile(real):
        raise FileNotFoundError("no checkpoint at {0}".format(real))
    with open(real, "rb") as f:
        state = pickle.load(f)
    if device is None and target is not None:
        device = next((leaf.device for leaf in _leaves(target)
                       if torch.is_tensor(leaf)), None)
    device = resolve_device(device)

    def to_device(leaf):
        if isinstance(leaf, np.ndarray) or np.isscalar(leaf):
            return torch.as_tensor(np.array(leaf), device=device)
        return leaf

    state = _map(to_device, state)
    if target is not None:
        state = _unflatten(target, _leaves(state))
    return state


def sampler_state(states, key, step_size, inv_mass, extra=None):
    """Bundle resumable sampling state into one tree (``key``: a seed, a
    generator's state or a ``torch.Generator``, saved as its state)."""
    out = {
        "chain_states": states,
        "key": key,
        "step_size": step_size,
        "inv_mass": inv_mass,
    }
    if extra:
        out.update(extra)
    return out
