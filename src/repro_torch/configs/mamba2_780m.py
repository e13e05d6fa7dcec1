"""mamba2-780m: attention-free SSM LM (SSD / state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-780m")
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        source="[arXiv:2405.21060; unverified]",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        attention="none",
        ssm_state_size=128,
        ssm_expand=2,
        ssm_head_dim=64,
        norm_type="rmsnorm",
        tie_embeddings=True,
    )
