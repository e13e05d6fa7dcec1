"""h2o-danube-1.8b: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("h2o-danube-1.8b")
def h2o_danube_1_8b() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        source="[arXiv:2401.16818; hf]",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        attention="gqa",
        sliding_window=4096,    # mistral-style SWA -> O(W) decode cache
        rope_theta=10_000.0,
    )
