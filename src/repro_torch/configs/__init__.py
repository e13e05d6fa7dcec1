"""Architecture registry: importing this package registers the configs the
port serves (the paper's MoE zoo)."""
from repro_torch.configs.base import (  # noqa: F401
    BlockSpec,
    ModelConfig,
    REGISTRY,
    get_config,
    list_configs,
    register,
)
from repro_torch.configs import paper_moes  # noqa: F401
