"""Mixture-of-Experts layer with per-layer (LExI) top-k:
``Router -> Dispatch -> Compute -> Combine``, as ``repro.models.moe``."""

from repro_torch.models.moe.compute import (  # noqa: F401
    add_shared,
    expert_ffn,
    grouped_ffn,
    grouped_ffn_quant,
    quant_leaves,
    routed_ffn,
    routed_ffn_quant,
)
from repro_torch.models.moe.decode import moe_decode  # noqa: F401
from repro_torch.models.moe.dense import moe_dense  # noqa: F401
from repro_torch.models.moe.dispatch import (  # noqa: F401
    SortPlan,
    default_block_m,
    make_sort_plan,
    sort_combine,
    sort_dispatch,
)
from repro_torch.models.moe.gmm import moe_gmm  # noqa: F401
from repro_torch.models.moe.params import (  # noqa: F401
    QUANT_DTYPES,
    dequantize_experts,
    init_moe,
    quantize_expert_params,
    quantize_experts,
    quantize_moe_layer,
    unpack_int4,
)
from repro_torch.models.moe.registry import (  # noqa: F401
    DECODE_TOKEN_THRESHOLD,
    moe,
    resolve_impl,
)
from repro_torch.models.moe.router import capacity, route, \
    route_lookahead  # noqa: F401
