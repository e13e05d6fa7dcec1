"""The port's params as the reference's tree, for the ``test_torch_*``
files that hold the port's weights and gradients to the reference's
(``from _torch_ref import reference_params``)."""

from typing import Dict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models.blocks import group_pattern  # noqa: E402
from repro_torch.tree import map_tree  # noqa: E402


def reference_params(params: Dict, cfg: ModelConfig) -> Dict:
    """The inverse of ``convert_params``: the port's params as the
    reference's tree, numpy leaves on the host (bf16 as float32, which
    numpy lacks): each run of identical layers stacked into one group, the
    shared_attn set under ``stack``."""
    def to_numpy(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out = {k: map_tree(to_numpy, v) for k, v in params.items()
           if k not in ("layers", "shared_attn")}
    if "layers" not in params:
        return out
    groups = []
    for g in group_pattern(cfg.pattern()):
        run = [map_tree(to_numpy, lp)
               for lp in params["layers"][g.start:g.start + g.count]]
        groups.append(run[0] if g.count == 1 else
                      map_tree(lambda *xs: np.stack(xs), *run))
    out["stack"] = {"groups": groups}
    if "shared_attn" in params:
        out["stack"]["shared_attn"] = map_tree(to_numpy,
                                               params["shared_attn"])
    return out
