"""llama4-scout-17b-a16e: MoE with 16 experts, top-1 routing, shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

NOTE (DESIGN.md §Arch-applicability): the paper's own Limitations section calls
out Llama-4's top-1 routing as the case where LExI is inapplicable -- there is
no k below the baseline to search.  The arch is fully supported; a LExI plan for
it is the identity plan (1,)*L.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama4-scout-17b-a16e")
def llama4_scout() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=202048,
        attention="gqa",
        num_experts=16,
        moe_top_k=1,
        moe_d_ff=8192,
        num_shared_experts=1,
        shared_expert_d_ff=8192,
        router_type="sigmoid",   # llama4 sigmoid router
        rope_theta=500_000.0,
    )
