"""qwen3-32b: dense LM with GQA + qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-32b")
def qwen3_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        source="[hf:Qwen/Qwen3-8B; hf]",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        attention="gqa",
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
