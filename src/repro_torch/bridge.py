"""Weight bridge: the JAX package's parameter tree → the port's parameters.

``params_from_jax`` takes the JAX ``init_lm`` + ``materialize`` tree with
numpy leaves (``jax.tree.map(np.asarray, params)``) and returns the port's
dict, unstacking ``params["stacks"][0]`` along its leading layer axis into
``params["layers"]``.  Both packages then compute the same function, which
is how the tests hold the port against the reference.  Dense family only.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _convert(tree: dict, dtype: torch.dtype, device, layer=None) -> dict:
    """numpy leaves → tensors; norm scales stay f32, the rest ``dtype``.
    ``layer`` picks one slice of a stacked tree's leading axis."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _convert(v, dtype, device, layer)
            continue
        arr = np.asarray(v) if layer is None else np.asarray(v)[layer]
        # numpy has no bfloat16: go through float32 (exact for bf16 values)
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        out[name] = t.to(device=device, dtype=torch.float32
                         if name == "scale" else dtype)
    return out


def params_from_jax(np_params: dict, cfg, *, device=None) -> dict:
    """Convert the JAX dense-LM parameter tree to the port's layout on
    ``device`` (the GPU unless given)."""
    dev = resolve_device(device)
    if len(np_params["stacks"]) != 1:
        raise ValueError("params_from_jax: only the dense family (one layer "
                         "stack) is ported")
    dt = cfg.tdtype
    stack = np_params["stacks"][0]
    return {"embed": _convert(np_params["embed"], dt, dev),
            "layers": [_convert(stack, dt, dev, layer=i)
                       for i in range(cfg.n_layers)],
            "final_norm": _convert(np_params["final_norm"], dt, dev)}
