"""Weight bridge: the reference's params pytree (and train state) -> the
port's tensors.

The reference stores the layer stack grouped: ``params["stack"]["groups"]
[gi]`` holds one dict per run of identical layers (``blocks.group_pattern``
of the config's pattern), with a leading layer-count axis when the run has
more than one layer.  The port keeps one dict per layer, so the groups are
split here; a shared_attn group is ``{}`` in both, and the one shared
parameter set moves from ``params["stack"]["shared_attn"]`` to
``params["shared_attn"]``.  The encoder-decoder's ``enc_layers`` and
``dec_layers`` are plain lists in both trees and map leaf for leaf.  The
input is nested dicts of numpy arrays (the caller converts device arrays
first, e.g. with ``jax.tree.map(np.asarray, params)``); this module
imports nothing of the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import group_pattern
from repro_torch.models.common import resolve_device
from repro_torch.optim import AdamWState
from repro_torch.training.step import TrainState
from repro_torch.tree import map_tree


def split_stack(stack: Dict, cfg: ModelConfig) -> List[Dict]:
    """Grouped stack -> one numpy param dict per layer."""
    layers: List[Dict] = []
    for gi, g in enumerate(group_pattern(cfg.pattern())):
        gp = stack["groups"][gi]
        if g.count == 1:
            layers.append(gp)
        else:
            layers.extend(map_tree(lambda a, i=i: a[i], gp)
                          for i in range(g.count))
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

    out = {k: map_tree(to_tensor, v) for k, v in params.items()
           if k != "stack"}
    if "stack" in params:
        out["layers"] = [map_tree(to_tensor, lp)
                         for lp in split_stack(params["stack"], cfg)]
        if "shared_attn" in params["stack"]:
            out["shared_attn"] = map_tree(to_tensor,
                                          params["stack"]["shared_attn"])
    return out


def convert_train_state(state, cfg: ModelConfig, *, device=None):
    """The reference's ``TrainState`` (numpy leaves, e.g. after
    ``jax.tree.map(np.asarray, state)``) -> the port's: params, AdamW
    moments and the compression error state split per layer as the
    params, and the step count."""
    def tree(t):
        return None if t is None else convert_params(t, cfg, device=device)

    opt = AdamWState(step=int(np.asarray(state.opt.step)),
                     mu=tree(state.opt.mu), nu=tree(state.opt.nu))
    return TrainState(params=tree(state.params), opt=opt,
                      err=tree(state.err))
