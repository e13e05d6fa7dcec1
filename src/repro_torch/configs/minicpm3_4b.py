"""minicpm3-4b: dense LM with Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("minicpm3-4b")
def minicpm3_4b() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        source="[hf:openbmb/MiniCPM3-4B; hf]",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        attention="mla",
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        rope_theta=10_000.0,
    )
