"""Sharding rules (``rules.py``) and the collectives over a mesh's axes
(``comm.py``)."""

from repro_torch.sharding.rules import (  # noqa: F401
    Sharding,
    batch_spec,
    batch_specs,
    cache_specs,
    data_axes,
    data_axes_size,
    gather_tree,
    is_expert_weight,
    is_spec,
    local_cache_specs,
    local_params,
    local_specs,
    local_tree,
    named,
    opt_state_specs,
    param_shardings,
    param_specs,
    spec_for_param,
    tokens_spec,
)
