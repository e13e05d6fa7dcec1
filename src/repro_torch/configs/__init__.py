"""Architecture registry: importing this package registers every config the
port serves: the paper's MoE models (``paper_moes``) and the reference's
ten assigned architectures (``ASSIGNED``), with the reference's shape
suites and their applicability (``shapes``)."""
from repro_torch.configs.base import (  # noqa: F401
    BlockSpec,
    ModelConfig,
    REGISTRY,
    get_config,
    list_configs,
    register,
)

# Assigned architectures (the 40-cell pool).
from repro_torch.configs import olmo_1b  # noqa: F401
from repro_torch.configs import minicpm3_4b  # noqa: F401
from repro_torch.configs import qwen3_32b  # noqa: F401
from repro_torch.configs import h2o_danube_1_8b  # noqa: F401
from repro_torch.configs import llama4_scout_17b_a16e  # noqa: F401
from repro_torch.configs import qwen3_moe_235b_a22b  # noqa: F401
from repro_torch.configs import pixtral_12b  # noqa: F401
from repro_torch.configs import zamba2_1_2b  # noqa: F401
from repro_torch.configs import mamba2_780m  # noqa: F401
from repro_torch.configs import whisper_base  # noqa: F401

# The paper's own MoE zoo (faithful-reproduction targets).
from repro_torch.configs import paper_moes  # noqa: F401

from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES,
    SHAPE_BY_NAME,
    SUBQUADRATIC_ARCHS,
    ShapeSpec,
    applicability,
    cells,
)

#: the ten assigned archs, in assignment order (rows of the 40-cell table)
ASSIGNED = (
    "olmo-1b",
    "minicpm3-4b",
    "qwen3-32b",
    "h2o-danube-1.8b",
    "llama4-scout-17b-a16e",
    "qwen3-moe-235b-a22b",
    "pixtral-12b",
    "zamba2-1.2b",
    "mamba2-780m",
    "whisper-base",
)

#: the paper's own MoE models (Table 1)
PAPER_MOES = (
    "olmoe-1b-7b",
    "mixtral-8x7b",
    "qwen1.5-moe-a2.7b",
    "minicpm-moe-8x2b",
    "deepseek-v2-lite",
)

#: the assigned architectures that serve on the paged engine, in the order
#: they were ported (chip_smoke's ``families`` phase); the stateful stacks
#: (mamba2-780m, zamba2-1.2b) and the encoder-decoder (whisper-base) run in
#: its ``ssm_encdec`` phase
FAMILIES = (
    "qwen3-moe-235b-a22b",
    "llama4-scout-17b-a16e",
    "qwen3-32b",
    "h2o-danube-1.8b",
    "minicpm3-4b",
    "olmo-1b",
    "pixtral-12b",
)
