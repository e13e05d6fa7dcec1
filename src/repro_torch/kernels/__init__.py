"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper runs its plain version for a tensor that lies on the CPU and
launches its CUDA kernel for a tensor on the card (or raises); there is no
fallback between the two.  On ``meta`` (the dry run) it checks what the
card's route checks and returns empty outputs.  Each wrapper counts its
kernel launches in a plain integer attribute, ``<wrapper>.launches``, and
reports each launch's cost (and each ``meta`` call's) to the open
``analysis.counters.count`` blocks (``costs.py``).
"""

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode_paged import flash_decode_paged, \
    flash_decode_paged_mla
from repro_torch.kernels.moe_decode import moe_decode, moe_decode_quant
from repro_torch.kernels.moe_ffn import moe_ffn
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_quant

WRAPPERS = {"moe_gmm": moe_gmm, "moe_decode": moe_decode,
            "flash_decode_paged": flash_decode_paged,
            "flash_attention": flash_attention, "flash_decode": flash_decode,
            "moe_gmm_quant": moe_gmm_quant,
            "moe_decode_quant": moe_decode_quant,
            "flash_decode_paged_mla": flash_decode_paged_mla,
            "moe_ffn": moe_ffn}


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
