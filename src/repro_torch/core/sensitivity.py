"""LExI Stage 1: per-layer top-k perturbation profiling (paper Alg. 1).

As the reference (``repro.core.sensitivity``): synthetic inputs
``X ~ N(0,1)^{B*L x H}`` (no calibration data); each MoE layer in
isolation runs at the pretrained top-k and at every candidate k, on the
dropless ``gmm`` path -- through the ``moe_gmm`` kernel on the card; the
perturbation is ``||Y_k - Y_base||_F`` averaged over ``n_iter`` draws.

The per-draw work is ``layer_deltas`` (a function of X), so a test can
feed it the reference's own X draws: the JAX and torch generators differ.

The reference jits ``layer_deltas``; on the card ``profile_sensitivity``
runs it as one CUDA graph a MoE layer, on that layer's weights: each draw
of X comes from the seeded generator outside the graph and is copied into
the graph's static input, so the draws, and the table's bits, are the
eager ones (``graphs=False``, the oracle; the CPU always runs eagerly).
The layer's first draw runs eagerly, the capture follows, and the later
draws replay.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation_dtype, resolve_device
from repro_torch.models.moe import moe_gmm


@dataclass
class SensitivityTable:
    """D[layer][k-1] = mean Frobenius deviation of running layer at top-k."""

    arch: str
    k_base: int
    moe_layer_indices: Tuple[int, ...]
    target_topks: Tuple[int, ...]
    n_iter: int
    values: np.ndarray  # [n_moe_layers, len(target_topks)]

    @property
    def num_layers(self) -> int:
        return self.values.shape[0]

    def loss(self, layer: int, k: int) -> float:
        return float(self.values[layer, self.target_topks.index(k)])

    def normalized(self) -> np.ndarray:
        """Per-layer max-normalized (for Fig. 3-style heatmaps)."""
        mx = self.values.max(axis=1, keepdims=True)
        return self.values / np.maximum(mx, 1e-12)

    def save(self, path: str) -> None:
        d = dataclasses.asdict(self)
        d["values"] = self.values.tolist()
        with open(path, "w") as f:
            json.dump(d, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "SensitivityTable":
        with open(path) as f:
            d = json.load(f)
        d["values"] = np.asarray(d["values"], np.float64)
        d["moe_layer_indices"] = tuple(d["moe_layer_indices"])
        d["target_topks"] = tuple(d["target_topks"])
        return cls(**d)


def iter_moe_layer_params(params: Dict, cfg: ModelConfig
                          ) -> Iterator[Tuple[int, Dict]]:
    """Yields (layer_index, moe_params) for every MoE layer."""
    for i, spec in enumerate(cfg.pattern()):
        if spec.kind == "attn_moe":
            yield i, params["layers"][i]["moe"]


@torch.no_grad()
def layer_deltas(moe_params: Dict, cfg: ModelConfig, x: torch.Tensor,
                 target_topks: Sequence[int],
                 use_kernel: bool = True) -> torch.Tensor:
    """One Monte-Carlo draw for one layer: x [T, D] -> deltas
    [len(target_topks)] f32, ``||Y_k - Y_base||_F`` per candidate k."""
    y_base, _ = moe_gmm(moe_params, cfg, x, cfg.moe_top_k, use_kernel)
    deltas = []
    for k in target_topks:
        y_k, _ = moe_gmm(moe_params, cfg, x, int(k), use_kernel)
        deltas.append(torch.linalg.vector_norm((y_k - y_base).float()))
    return torch.stack(deltas)


def profile_sensitivity(
    params: Dict,
    cfg: ModelConfig,
    *,
    n_iter: int = 16,
    batch: int = 4,
    seq: int = 64,
    target_topks: Optional[Sequence[int]] = None,
    seed: int = 0,
    device=None,
    use_kernel: bool = True,
    graphs: Optional[bool] = None,
) -> SensitivityTable:
    """Run Alg. 1 over every MoE layer; X is drawn on ``device`` from a
    generator seeded with ``seed``.  ``graphs`` (None: True): a CUDA graph
    a layer on the card (module doc)."""
    if not cfg.is_moe:
        raise ValueError(f"{cfg.name} has no MoE layers (LExI inapplicable)")
    if cfg.moe_top_k < 2:
        raise ValueError(
            f"{cfg.name}: top-k={cfg.moe_top_k} leaves no search space below "
            "baseline (paper §6 Limitations, e.g. Llama-4 top-1)")
    if target_topks is None:
        target_topks = tuple(range(1, cfg.moe_top_k + 1))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    graphed = (graphs is None or bool(graphs)) and dev.type == "cuda"
    if graphed:
        from repro_torch.kernels import _graphs
        stream = _graphs.side_stream(dev)
        pool = torch.cuda.graph_pool_handle()
        x_in = torch.empty((batch * seq, cfg.d_model),
                           dtype=activation_dtype(cfg), device=dev)
    layer_ids: List[int] = []
    rows: List[np.ndarray] = []
    # every layer's graph lives to the end of the call: graphs that share
    # a memory pool replay one after another, never at once
    kept = []
    for layer_idx, moe_params in iter_moe_layer_params(params, cfg):
        acc = torch.zeros(len(target_topks), dtype=torch.float64, device=dev)
        graph = None

        def deltas(x, moe_params=moe_params):
            return layer_deltas(moe_params, cfg, x, target_topks, use_kernel)
        for i in range(n_iter):
            x = torch.randn((batch * seq, cfg.d_model), generator=gen,
                            device=dev).to(activation_dtype(cfg))
            if not graphed:
                acc += deltas(x).double()
                continue
            x_in.copy_(x)
            if i == 0:
                acc += _graphs.on_stream(lambda: deltas(x_in),
                                         stream).double()
                continue
            if graph is None:
                graph = _graphs.capture(lambda: deltas(x_in), stream=stream,
                                        pool=pool)
                kept.append(graph)
            acc += graph.replay().double()
        layer_ids.append(layer_idx)
        rows.append((acc / n_iter).cpu().numpy())
    return SensitivityTable(
        arch=cfg.name,
        k_base=cfg.moe_top_k,
        moe_layer_indices=tuple(layer_ids),
        target_topks=tuple(int(k) for k in target_topks),
        n_iter=n_iter,
        values=np.stack(rows),
    )
