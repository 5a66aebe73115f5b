"""Parameters from the JAX reference, as numpy arrays, to the port.

``params_from_numpy(tree, device)`` takes the reference's parameter tree
with numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's: the same dictionaries, with the layer-stacked
``[L, ...]`` leaves under ``"layers"`` (and whisper's ``"enc_layers"`` and
``"dec_layers"``) unstacked into lists of per-layer dictionaries.  Raw and wire-packed trees convert alike.  bfloat16 leaves
(ml_dtypes arrays) cross bit for bit through a ``uint16`` view.  Any
tree shaped like the params converts the same way: the W-DBB masks, the
error-feedback residuals, and the optimizer's moments
(:func:`opt_state_from_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy array -> tensor, bit-exact (bfloat16 via a uint16 view)."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# the reference's layer-stacked subtrees (decoder-only LM; whisper's
# encoder and decoder)
STACKED = ("layers", "enc_layers", "dec_layers")


def _unstack(subtree, device):
    leaves = []
    _map(subtree, leaves.append)
    n_layers = int(np.asarray(leaves[0]).shape[0])
    return [_map(subtree, lambda a, i=i: tensor_from_numpy(np.asarray(a)[i], device))
            for i in range(n_layers)]


def params_from_numpy(tree, device="cpu"):
    """The reference's parameter tree (numpy leaves) -> the port's."""
    return {k: (_unstack(v, device) if k in STACKED
                else _map(v, lambda a: tensor_from_numpy(a, device)))
            for k, v in tree.items()}


def opt_state_from_numpy(step, mu, nu, device="cpu"):
    """The reference's ``OptState`` (numpy leaves) -> the port's: ``mu``
    and ``nu`` unstacked like the params, ``step`` a 0-d int32 tensor on
    the CPU (where the port keeps it)."""
    from repro_torch.train.optimizer import OptState

    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32),
                    mu=params_from_numpy(mu, device), nu=params_from_numpy(nu, device))
