"""The paper's own MoE model zoo (Table 1) as additional configs.

These carry the *faithful reproduction*: LExI's Alg. 1/2 and the pruning
baselines are evaluated on these families (at reduced scale for CPU benches,
at full scale through the dry-run).  They are additive to the 10 assigned
archs -- the 40-cell roofline table covers only the assigned pool.

| Model                      | #L | #E | TopK | moe_ffn |
|----------------------------|----|----|------|---------|
| OLMoE-1B-7B                | 16 | 64 | 8    | 1024    |
| Qwen1.5-MoE-A2.7B          | 24 | 60 | 4    | 1408    |
| DeepSeek-V2-Lite           | 27 | 64 | 6    | 1408    |
| MiniCPM-MoE-8x2B           | 40 | 8  | 2    | 5760    |
| Mixtral-8x7B               | 32 | 8  | 2    | 14336   |
"""
from repro_torch.configs.base import ModelConfig, register


@register("olmoe-1b-7b")
def olmoe() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        source="[arXiv:2409.02060; hf] (paper Table 1)",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=0,
        vocab_size=50304,
        attention="gqa",
        qk_norm=True,                # OLMoE uses QK-norm
        num_experts=64,
        moe_top_k=8,
        moe_d_ff=1024,
        router_type="softmax",
        norm_topk_prob=False,
    )


@register("mixtral-8x7b")
def mixtral() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        source="[arXiv:2401.04088; hf] (paper Table 1)",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=32000,
        attention="gqa",
        num_experts=8,
        moe_top_k=2,
        moe_d_ff=14336,
        router_type="softmax",
        norm_topk_prob=True,         # Mixtral renormalizes the top-k probs
    )


@register("qwen1.5-moe-a2.7b")
def qwen15_moe() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-moe-a2.7b",
        family="moe",
        source="[qwenlm.github.io/blog/qwen-moe; hf] (paper Table 1)",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=0,
        vocab_size=151936,
        attention="gqa",
        num_experts=60,
        moe_top_k=4,
        moe_d_ff=1408,
        num_shared_experts=4,
        shared_expert_d_ff=5632,
        router_type="softmax",
        norm_topk_prob=False,
    )


@register("minicpm-moe-8x2b")
def minicpm_moe() -> ModelConfig:
    return ModelConfig(
        name="minicpm-moe-8x2b",
        family="moe",
        source="[arXiv:2404.06395; hf] (paper Table 1)",
        num_layers=40,
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        head_dim=64,
        d_ff=0,
        vocab_size=122753,
        attention="gqa",
        num_experts=8,
        moe_top_k=2,
        moe_d_ff=5760,
        router_type="softmax",
        norm_topk_prob=True,
    )


@register("deepseek-v2-lite")
def deepseek_v2_lite() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        source="[arXiv:2405.04434; hf] (paper Table 1)",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,                  # first layer is dense
        vocab_size=102400,
        attention="mla",
        q_lora_rank=0,               # V2-Lite: no q compression
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=64,
        moe_top_k=6,
        moe_d_ff=1408,
        num_shared_experts=2,
        shared_expert_d_ff=2816,
        first_k_dense=1,
        router_type="softmax",
        norm_topk_prob=False,
    )
