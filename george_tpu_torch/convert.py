# -*- coding: utf-8 -*-
"""Carry GP parameters across from the JAX package.

The two packages share the modeling protocol, so a GP built from the same
kernel expression has the same parameter names, in the same order, in
both.  :func:`load_reference_parameters` copies the values and the frozen
set of a reference GP (handed over as plain numpy / Python data, so this
package imports nothing of the other) into a GP of this package.
"""

import numpy as np

__all__ = ["load_reference_parameters"]


def load_reference_parameters(gp, names, vector, unfrozen_mask):
    """Set ``gp``'s full parameter vector and frozen set from a reference.

    :param gp: a :class:`george_tpu_torch.GP` (or any modeling-protocol
        model) built from the same kernel expression.
    :param names: the reference's ``get_parameter_names(include_frozen=True)``.
    :param vector: its ``get_parameter_vector(include_frozen=True)``.
    :param unfrozen_mask: its ``unfrozen_mask`` (True = active).
    :raises ValueError: if the names differ, in content or order, or the
        lengths disagree.
    """
    names = tuple(str(n) for n in names)
    mine = tuple(gp.get_parameter_names(include_frozen=True))
    if names != mine:
        raise ValueError(
            "parameter names differ: reference {0} vs {1}".format(names, mine)
        )
    vector = np.asarray(vector, dtype=np.float64)
    unfrozen_mask = np.asarray(unfrozen_mask, dtype=bool)
    if vector.shape != (len(names),) or unfrozen_mask.shape != (len(names),):
        raise ValueError("vector and mask must have one entry per name")
    gp.set_parameter_vector(vector, include_frozen=True)
    for name, active in zip(names, unfrozen_mask):
        if active:
            gp.thaw_parameter(name)
        else:
            gp.freeze_parameter(name)
    return gp
