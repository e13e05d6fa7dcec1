"""whisper-base: encoder-decoder with conv audio frontend (stub).
[arXiv:2212.04356; unverified]

The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings ``[B, encoder_seq_len, d_model]``.  Positional
encoding uses RoPE in this implementation (hardware-shape-equivalent to
Whisper's sinusoidal/learned positions; noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-base")
def whisper_base() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        source="[arXiv:2212.04356; unverified]",
        num_layers=6,            # decoder layers
        encoder_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        attention="gqa",
        is_encoder_decoder=True,
        encoder_seq_len=1500,    # 30s audio -> 1500 frames after conv stub
        norm_type="layernorm",
        max_seq_len=448,
    )
