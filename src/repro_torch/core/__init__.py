"""LExI core: profile (Alg. 1), search (Alg. 2), plan, and the pruning
baselines the paper compares against."""
from repro_torch.core.apply import apply_plan_params, lexi_config, \
    optimize  # noqa: F401
from repro_torch.core.plan import LexiPlan, apply_plan, uniform_plan, \
    validate_plan  # noqa: F401
from repro_torch.core.search import SearchResult, dp_optimal, \
    evolutionary_search  # noqa: F401
from repro_torch.core.sensitivity import SensitivityTable, \
    iter_moe_layer_params, layer_deltas, profile_sensitivity  # noqa: F401
from repro_torch.core.pruning import inter_prune, intra_prune  # noqa: F401
from repro_torch.core.skipping import expected_skip_rate, \
    with_dynamic_skipping  # noqa: F401
