"""Architecture registry: importing this package registers the configs the
port serves: the paper's MoE models (``paper_moes``) and five of the
reference's assigned architectures -- two MoE LMs (qwen3-moe-235b-a22b,
llama4-scout-17b-a16e), two dense GQA LMs (qwen3-32b; h2o-danube-1.8b with a
sliding window) and a dense MLA LM (minicpm3-4b)."""
from repro_torch.configs.base import (  # noqa: F401
    BlockSpec,
    ModelConfig,
    REGISTRY,
    get_config,
    list_configs,
    register,
)
from repro_torch.configs import paper_moes  # noqa: F401
from repro_torch.configs import qwen3_moe_235b_a22b  # noqa: F401
from repro_torch.configs import llama4_scout_17b_a16e  # noqa: F401
from repro_torch.configs import qwen3_32b  # noqa: F401
from repro_torch.configs import h2o_danube_1_8b  # noqa: F401
from repro_torch.configs import minicpm3_4b  # noqa: F401

#: the reference's assigned architectures the port serves, in the order
#: they were ported
FAMILIES = (
    "qwen3-moe-235b-a22b",
    "llama4-scout-17b-a16e",
    "qwen3-32b",
    "h2o-danube-1.8b",
    "minicpm3-4b",
)
