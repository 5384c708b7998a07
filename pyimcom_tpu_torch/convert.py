"""
Carry the reference's state across to the port.

The JAX package's intermediate arrays -- overlap stacks, sweep tables and
metadata, A, -B/2, data, one-hot and fade, the kappa node array, the
acceptance mask and distances -- reach the port as NumPy arrays
(``np.asarray`` of the JAX outputs).  :func:`from_numpy` turns a tree of
them into port tensors on one device, so both packages can be fed identical
inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DTYPE


def from_numpy(tree, device):
    """Convert a tree (dict / list / tuple) of arrays to tensors on `device`.

    Floating arrays become float64 tensors; integer and boolean arrays keep
    their dtype (the kernels' metadata is int32, the Iterative kernel's
    acceptance mask bool).
    """
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    # torch.tensor copies: a JAX output's NumPy view is read-only
    arr = np.asarray(tree)
    if arr.dtype.kind == "f":
        return torch.tensor(arr, dtype=DTYPE, device=device)
    if arr.dtype.kind in "iub":
        return torch.tensor(arr, device=device)
    raise TypeError(f"cannot convert an array of dtype {arr.dtype} to the port")
