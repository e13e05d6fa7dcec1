"""olmo-1b: dense LM with non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("olmo-1b")
def olmo_1b() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        source="[arXiv:2402.00838; hf]",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        attention="gqa",
        norm_type="nonparam_ln",   # OLMo's non-parametric LayerNorm
        rope_theta=10_000.0,
    )
