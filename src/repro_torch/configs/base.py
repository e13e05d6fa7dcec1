"""Model configuration system (the port's own copy of ``repro.configs.base``).

Every architecture is described by a single frozen ``ModelConfig``.
Configs register themselves in ``REGISTRY`` (one module per arch under
``repro_torch.configs``) and are retrieved with ``get_config(name)``.

Design notes
------------
* ``block_pattern`` fully determines the layer stack: a tuple with one entry per
  layer, each entry a ``BlockSpec`` (kind + static attributes such as the MoE
  top-k for that layer).  The port runs the stack as a Python loop over
  layers, one parameter dict per layer.
* A LExI plan is applied with ``with_lexi_plan``: it rewrites the per-layer
  ``moe_top_k`` inside the pattern, which sets each layer's routed-expert
  count (and so the work the MoE kernels issue).
* ``reduced()`` produces a tiny same-family config for CPU tests.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple

# --------------------------------------------------------------------------- #
# Block specs
# --------------------------------------------------------------------------- #

#: Valid block kinds.
BLOCK_KINDS = (
    "attn_mlp",      # attention + dense MLP
    "attn_moe",      # attention + MoE FFN
    "mamba",         # Mamba2 (SSD) block
    "shared_attn",   # Zamba2-style shared attention+MLP block (single param set)
    "moe_only",      # (unused placeholder for router-only studies)
)


@dataclass(frozen=True)
class BlockSpec:
    """Static description of one layer.

    ``moe_top_k`` is carried per-layer so a LExI plan can vary it across depth;
    for non-MoE blocks it is 0.

    ``split_id`` is a grouping tag: specs that differ only in ``split_id`` are
    numerically identical but land in different scan groups.  Serving assigns a
    unique id per layer so the KV-cache pytree has one entry per layer and is
    therefore *independent* of the per-layer top-k — a requirement for serving
    heterogeneous per-request plans against one cache (DESIGN.md §10).
    """

    kind: str
    moe_top_k: int = 0
    split_id: int = 0

    def __post_init__(self):
        if self.kind not in BLOCK_KINDS:
            raise ValueError(f"unknown block kind {self.kind!r}")


# --------------------------------------------------------------------------- #
# Model config
# --------------------------------------------------------------------------- #


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------- #
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    source: str = ""                 # provenance note ([arXiv:...; tier])

    # -- core transformer dims ---------------------------------------------- #
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    vocab_pad_multiple: int = 64     # vocab rounded up for shardability
    tie_embeddings: bool = False

    # -- attention variant --------------------------------------------------- #
    attention: str = "gqa"           # gqa | mla | none
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA window (tokens), None = full
    rope_theta: float = 10_000.0
    # MLA dims (used when attention == "mla")
    q_lora_rank: int = 0             # 0 -> no q compression
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # -- MoE ----------------------------------------------------------------- #
    num_experts: int = 0             # 0 -> dense MLP
    moe_top_k: int = 0               # baseline (pretrained) top-k
    moe_d_ff: int = 0                # per-expert FFN inner dim
    num_shared_experts: int = 0      # always-on shared experts (Qwen/DeepSeek)
    shared_expert_d_ff: int = 0      # inner dim of the fused shared expert
    router_type: str = "softmax"     # softmax | sigmoid
    norm_topk_prob: bool = False     # renormalize the selected k probabilities
    first_k_dense: int = 0           # leading dense layers (DeepSeek-style)
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dense"          # dense | gmm | ep_a2a | ep_psum (models/moe/)
    #: NAEE-style dynamic expert skipping threshold (baseline; 0 = off).
    #: Zeroes slot s>0 when weight_s < tau * weight_0.  Data-dependent, so it
    #: does not shrink the routed work -- quality effect only.
    dynamic_skip_tau: float = 0.0

    # -- SSM (Mamba2 / SSD) --------------------------------------------------- #
    ssm_state_size: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256             # SSD chunk length
    #: unroll the SSD chunk scan (kept for field parity with the reference)
    ssm_scan_unroll: bool = False
    attn_period: int = 0             # hybrid: one shared attn block every N layers

    # -- encoder-decoder ------------------------------------------------------ #
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0         # stub frontend output length (whisper frames)

    # -- modality frontend stubs ---------------------------------------------- #
    prefix_embed_len: int = 0        # VLM: number of precomputed patch embeddings

    # -- norm / misc ----------------------------------------------------------- #
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: str = "bfloat16"

    # -- LExI ------------------------------------------------------------------ #
    lexi_plan: Optional[Tuple[int, ...]] = None   # per-MoE-layer top-k override

    # -- explicit layer stack (derived if None) -------------------------------- #
    block_pattern: Optional[Tuple[BlockSpec, ...]] = None

    # ------------------------------------------------------------------ #
    # Derived helpers
    # ------------------------------------------------------------------ #
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    def pattern(self) -> Tuple[BlockSpec, ...]:
        """The resolved per-layer stack (applies family defaults + LExI plan)."""
        if self.block_pattern is not None:
            pat = list(self.block_pattern)
        else:
            pat = []
            for i in range(self.num_layers):
                if self.attn_period and (i % self.attn_period == self.attn_period - 1):
                    pat.append(BlockSpec("shared_attn"))
                elif self.ssm_state_size and not self.is_moe:
                    pat.append(BlockSpec("mamba"))
                elif self.ssm_state_size:
                    pat.append(BlockSpec("mamba"))
                elif self.is_moe and i >= self.first_k_dense:
                    pat.append(BlockSpec("attn_moe", self.moe_top_k))
                else:
                    pat.append(BlockSpec("attn_mlp"))
        if self.block_pattern is None and self.attn_period and self.ssm_state_size:
            # hybrid family: non-shared slots are mamba
            pat = [
                BlockSpec("shared_attn")
                if (i % self.attn_period == self.attn_period - 1)
                else BlockSpec("mamba")
                for i in range(self.num_layers)
            ]
        if self.lexi_plan is not None:
            moe_positions = [i for i, b in enumerate(pat) if b.kind == "attn_moe"]
            if len(self.lexi_plan) != len(moe_positions):
                raise ValueError(
                    f"lexi_plan length {len(self.lexi_plan)} != "
                    f"#MoE layers {len(moe_positions)} in {self.name}"
                )
            for pos, k in zip(moe_positions, self.lexi_plan):
                if not (1 <= k <= self.num_experts):
                    raise ValueError(f"plan k={k} out of range at layer {pos}")
                pat[pos] = replace(pat[pos], moe_top_k=int(k))
        return tuple(pat)

    def moe_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, b in enumerate(self.pattern()) if b.kind == "attn_moe")

    @property
    def num_moe_layers(self) -> int:
        return len(self.moe_layer_indices())

    def with_lexi_plan(self, plan) -> "ModelConfig":
        return replace(self, lexi_plan=tuple(int(k) for k in plan))

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ------------------------------------------------------------------ #
    # Parameter counting (analytic; used for roofline MODEL_FLOPS)
    # ------------------------------------------------------------------ #
    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention == "none":
            return 0
        if self.attention == "mla":
            hd = self.qk_nope_head_dim + self.qk_rope_head_dim
            p = 0
            if self.q_lora_rank:
                p += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * hd
            else:
                p += d * self.num_heads * hd
            p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            p += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
            p += self.num_heads * self.v_head_dim * d
            return p
        hd = self.head_dim_
        return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d

    def _mlp_params(self) -> int:
        return 3 * self.d_model * self.d_ff  # SwiGLU gate/up/down

    def _moe_params(self, active_only: bool = False, top_k: Optional[int] = None) -> int:
        e = (top_k if top_k is not None else self.moe_top_k) if active_only else self.num_experts
        p = 3 * self.d_model * self.moe_d_ff * e
        p += self.d_model * self.num_experts  # router
        if self.num_shared_experts:
            sd = self.shared_expert_d_ff or self.moe_d_ff * self.num_shared_experts
            p += 3 * self.d_model * sd
        return p

    def _mamba_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        nheads = d_in // self.ssm_head_dim
        ng = 1  # single B/C group
        p = d * (2 * d_in + 2 * ng * self.ssm_state_size + nheads)  # in_proj
        p += self.ssm_conv_width * (d_in + 2 * ng * self.ssm_state_size)  # conv
        p += nheads * 2  # A_log, D
        p += nheads      # dt_bias
        p += d_in * d    # out_proj
        return p

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active, for MoE) parameter count, excluding frontend stubs."""
        total = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            total += self.padded_vocab * self.d_model
        shared_attn_counted = False
        for b in self.pattern():
            if b.kind == "attn_mlp":
                total += self._attn_params() + self._mlp_params()
            elif b.kind == "attn_moe":
                total += self._attn_params() + self._moe_params(
                    active_only=active_only, top_k=b.moe_top_k or None
                )
            elif b.kind == "mamba":
                total += self._mamba_params()
            elif b.kind == "shared_attn":
                if not shared_attn_counted:
                    total += self._attn_params() + self._mlp_params()
                    shared_attn_counted = True
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder adds cross-attention
            total += self.encoder_layers * (self._attn_params() + self._mlp_params())
            total += self.num_layers * self._attn_params()  # cross-attn
        return total

    # ------------------------------------------------------------------ #
    # Smoke-test reduction
    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw: Dict = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(max(self.num_kv_heads, 1), 4) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=256,
            vocab_pad_multiple=16,
            max_seq_len=128,
            dtype="float32",
            block_pattern=None,
            lexi_plan=None,
        )
        if self.attention == "mla":
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.is_moe:
            kw.update(num_experts=min(self.num_experts, 8),
                      moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k > 1 else self.moe_top_k,
                      moe_d_ff=64,
                      shared_expert_d_ff=64 if self.num_shared_experts else 0,
                      first_k_dense=min(self.first_k_dense, 1))
        if self.ssm_state_size:
            kw.update(ssm_state_size=16, ssm_head_dim=16, ssm_chunk=16)
        if self.attn_period:
            kw.update(attn_period=2)
        if self.sliding_window:
            kw.update(sliding_window=64)
        if self.is_encoder_decoder:
            kw.update(encoder_layers=2, encoder_seq_len=32)
        if self.prefix_embed_len:
            kw.update(prefix_embed_len=16)
        return replace(self, **kw)


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch module imports)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]()


def list_configs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(REGISTRY))
