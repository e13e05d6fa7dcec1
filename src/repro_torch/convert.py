"""Weight bridge: the reference's params pytree -> the port's tensors.

The reference stores the layer stack grouped: ``params["stack"]["groups"]
[gi]`` holds one dict per run of identical layers (``blocks.group_pattern``
of the config's pattern), with a leading layer-count axis when the run has
more than one layer.  The port keeps one dict per layer, so the groups are
split here.  The input is nested dicts of numpy arrays (the caller converts
device arrays first, e.g. with ``jax.tree.map(np.asarray, params)``); this
module imports nothing of the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import group_pattern
from repro_torch.models.common import resolve_device


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def split_stack(stack: Dict, cfg: ModelConfig) -> List[Dict]:
    """Grouped stack -> one numpy param dict per layer."""
    layers: List[Dict] = []
    for gi, g in enumerate(group_pattern(cfg.pattern())):
        gp = stack["groups"][gi]
        if g.count == 1:
            layers.append(gp)
        else:
            layers.extend(_map(gp, lambda a, i=i: a[i]) for i in range(g.count))
    return layers


def convert_params(params: Dict, cfg: ModelConfig, *, device=None) -> Dict:
    """Reference params (numpy leaves) -> port params on ``device``."""
    dev = resolve_device(device)

    def to_tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":       # ml_dtypes: no numpy view
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    out = {k: _map(v, to_tensor) for k, v in params.items() if k != "stack"}
    out["layers"] = [_map(lp, to_tensor)
                     for lp in split_stack(params["stack"], cfg)]
    return out
