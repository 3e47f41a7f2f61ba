"""Parameters between the JAX package (as numpy) and the port."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .utils.device import DeviceLike, resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "placed_from_jax"]


def params_from_jax(np_params: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A JAX param dict (``{k: np.asarray(v)}``) → tensors on ``device``,
    ready for ``model.load_state_dict``. The values are copied."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True)).to(dev)
        for k, v in np_params.items()
    }


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port params (or ``model.state_dict()``) → float32 numpy copies."""
    return {k: v.detach().to("cpu", torch.float32).numpy().copy()
            for k, v in params.items()}


def placed_from_jax(np_params: Mapping[str, np.ndarray], mesh,
                    rules: Optional[Mapping] = None):
    """A JAX param dict (numpy, global shapes) and name→spec rules → this
    rank's ``parallel.Placed`` blocks on the mesh's device (float32
    copies), ready for ``model.load_placed`` on a model placed by the
    same rules."""
    from .parallel.spmd import shard_params

    return shard_params({k: np.array(v, dtype=np.float32, copy=True)
                         for k, v in np_params.items()}, mesh, rules)
