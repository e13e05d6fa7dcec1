"""pixtral-12b: VLM -- pixtral-ViT frontend (stub) + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings of length ``prefix_embed_len`` that are
concatenated ahead of the token embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


@register("pixtral-12b")
def pixtral_12b() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        source="[hf:mistralai/Pixtral-12B-2409; unverified]",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        attention="gqa",
        prefix_embed_len=1024,   # one 1024-patch image per sequence (stub)
        rope_theta=1_000_000_000.0,
    )
