"""zamba2-1.2b: hybrid -- Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

Zamba2 interleaves a single *shared* attention+MLP block (one parameter set,
re-applied) into a Mamba2 stack; we place it every ``attn_period`` layers.
"""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-1.2b")
def zamba2_1_2b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        source="[arXiv:2411.15242; hf]",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        attention="gqa",
        ssm_state_size=64,
        ssm_expand=2,
        ssm_head_dim=64,
        attn_period=6,           # shared attn block every 6th layer
        rope_theta=10_000.0,
    )
