"""Sharding rules (``rules.py``) and the collectives over a mesh's axes
(``comm.py``)."""

from repro_torch.sharding.rules import (  # noqa: F401
    Sharding,
    batch_spec,
    batch_specs,
    cache_specs,
    data_axes,
    data_axes_size,
    fsdp_layout,
    gather_tree,
    is_spec,
    local_cache_specs,
    local_params,
    local_shardings,
    local_specs,
    local_tree,
    named,
    opt_state_specs,
    param_shardings,
    param_specs,
    shardings_for,
    spec_for_param,
    tokens_spec,
)
