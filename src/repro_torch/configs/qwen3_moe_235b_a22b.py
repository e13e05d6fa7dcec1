"""qwen3-moe-235b-a22b: 128-expert top-8 MoE with qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]

Primary LExI target in the assigned pool (multi-expert routed MoE).
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-moe-235b-a22b")
def qwen3_moe() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        source="[hf:Qwen/Qwen3-30B-A3B; hf]",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=0,
        vocab_size=151936,
        attention="gqa",
        qk_norm=True,
        num_experts=128,
        moe_top_k=8,
        moe_d_ff=1536,
        router_type="softmax",
        norm_topk_prob=True,
        rope_theta=1_000_000.0,
    )
