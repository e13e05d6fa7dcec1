"""Runtime model options (orthogonal to ModelConfig: how, not what).

Only the fields the port's serving slice reads are carried over from
``repro.models.opts``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelOpts:
    #: train / prefill attention through the flash_attention kernel
    #: instead of the masked softmax (causal, no pads: it masks by index)
    use_flash: bool = False
    #: MoE dispatch implementation override (None -> cfg.moe_impl):
    #: dense | gmm | decode (models/moe/registry.py)
    moe_impl: Optional[str] = None
    #: run expert FFNs through the hand-written kernels (moe_ffn on the
    #: capacity buffers, moe_gmm on the sorted dropless layout, moe_decode
    #: on the routed decode layout)
    use_moe_kernel: bool = False
    #: paged decode attends pages in-kernel (flash_decode_paged) instead
    #: of gathering the pool into a contiguous [B, n_blk*P] view first
    use_paged_kernel: bool = False
    #: decode attention over a contiguous view (the contiguous cache, or
    #: the gathered pages) through the flash_decode kernel instead of the
    #: masked softmax
    use_flash_decode: bool = False
    #: decode-regime MoE: reroute decode-step gmm dispatch for
    #: decode-shaped batches (T <= registry.DECODE_TOKEN_THRESHOLD)
    #: through the fused routed-expert path (models/moe/decode.py); no
    #: effect under dense, which can drop copies and is never rerouted
    use_moe_decode_kernel: bool = False
    #: routed expert storage: "bf16" (native: whatever the params store)
    #: or "int8" / "int4", quantized at load (Engine(expert_dtype=)) and
    #: dequantized in the moe_gmm_quant / moe_decode_quant kernels
    expert_dtype: str = "bf16"
    #: MLA chunk and decode with W_kv_b absorbed into the query and output
    #: projections (work scales with the latent rank; paged decode then runs
    #: the flash_decode_paged_mla kernel) instead of materialized k / v
    mla_absorb: bool = True
    #: attention score math: "f32" casts K/V to f32; "bf16_accum32" keeps
    #: the storage dtype for the products
    attn_compute_dtype: str = "f32"
    #: router lookahead: on decode steps, predict layer i's top-k ids from
    #: layer i-1's pre-FFN hidden and stage the expert-weight gathers of the
    #: plain routed path on the prediction, hit-selected against the true
    #: ids -- numerically a no-op (the CUDA kernels ignore the hint)
    router_lookahead: bool = False


DEFAULT_OPTS = ModelOpts()
