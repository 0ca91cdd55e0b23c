"""Parameters of the JAX package -> parameters of the port.

The reference's parameter pytree, fetched to the host and flattened to numpy
arrays keyed by ``path_str`` (the UPIR symbol names without the ``params/``
prefix, e.g. ``blocks/mlp/w1``), becomes the port's nested dict of tensors.
The caller does the fetch (``jax.device_get``), so the port never sees JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.lower import tree_symbols
from .device import DeviceLike, dtype_of, resolve_device
from .models import api


def from_reference(params_np: Mapping[str, np.ndarray], *,
                   cfg: ArchConfig = None,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """``{path: array}`` -> nested dict of tensors on ``device``.

    With ``cfg``, every name and shape must equal the port's
    ``api.param_specs(cfg)`` (and the dtype its ``param_dtype``); a missing,
    extra or mis-shaped parameter raises ``ValueError``.
    """
    dev = resolve_device(device)
    if cfg is not None:
        want = tree_symbols(api.param_specs(cfg))
        got = {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
               for k, v in params_np.items()}
        if set(want) != set(got):
            raise ValueError(f"parameter names differ: missing "
                             f"{sorted(set(want) - set(got))}, extra "
                             f"{sorted(set(got) - set(want))}")
        bad = {k: (got[k][0], want[k][0]) for k in want
               if got[k][0] != want[k][0]}
        if bad:
            raise ValueError(f"parameter shapes differ (got, want): {bad}")
    out: Dict[str, Any] = {}
    for path, arr in params_np.items():
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":       # ml_dtypes: no numpy cast
            t = torch.from_numpy(arr.astype(np.float32).copy()).to(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        if cfg is not None:
            t = t.to(dtype_of(cfg.param_dtype))
        node = out
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t.to(dev)
    return out


def to_flat(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of tensors -> ``{path: tensor}`` (the inverse layout)."""
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(params):
        name = f"{prefix}/{k}" if prefix else str(k)
        v = params[k]
        if isinstance(v, Mapping):
            out.update(to_flat(v, name))
        else:
            out[name] = v
    return out
