"""Three-term roofline of one rank's step against the H100's peaks (the
port's counterpart of ``repro.analysis.roofline``).

    compute term    = FLOPs_per_rank            / peak FLOP/s
    memory term     = HBM_bytes_per_rank        / HBM bytes/s
    collective term = collective_bytes_per_rank / link bytes/s

The per-rank numbers are those ``analysis/counters.py`` counts while the
port's own per-rank program runs (on ``meta`` in the dry run,
``launch/dryrun.py``): the eager program, unfused, with elementwise FLOPs
left out -- not XLA's ``cost_analysis()`` of the reference's compiled
module, and not comparable with it.  Dividing per-rank counts by per-card
peaks gives the step's bound directly (global = per rank x cards).

MODEL_FLOPS is 6 N D (train, dense), 6 N_active D (train, MoE) and
2 N_active D (forward-only serving steps); MODEL_FLOPS over the ranks'
counted FLOPs exposes remat and redundant compute.

``HW`` is the H100 SXM's published figures (NVIDIA's data sheet): 989
TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and 450 GB/s
each way over NVLink.  Two limits: a 16-wide axis spans two hosts of eight
cards, so a collective that crosses hosts runs over the slower network and
the collective term is a lower bound; and the rates assume the card's 700
W power limit (a card set lower runs slower under load).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.plan import model_flops_per_token

#: H100 SXM per-card constants (module doc); the reference's ``HW`` names
#: its link rate ``ici_bw``, and ``analyze_costs`` reads either name
HW = {
    "peak_flops": 989e12,   # bf16 dense FLOP/s
    "hbm_bw": 3.35e12,      # bytes/s
    "link_bw": 450e9,       # bytes/s each way (NVLink)
}


def _link_bw(hw: Dict) -> float:
    return hw["link_bw"] if "link_bw" in hw else hw["ici_bw"]


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw per-rank counts (the reference's field names)
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_breakdown: Dict[str, int]
    # derived terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    # usefulness
    model_flops_global: float
    useful_flops_ratio: float
    # memory
    bytes_per_device: Optional[float] = None
    note: str = ""
    #: the peak FLOP/s the fraction is taken of
    peak_flops: float = HW["peak_flops"]

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def roofline_fraction(self) -> float:
        """Fraction of the step bound that is useful compute at peak."""
        if self.bound_time <= 0:
            return 0.0
        t_useful = (self.model_flops_global / self.chips) / self.peak_flops
        return t_useful / self.bound_time

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["bound_time_s"] = self.bound_time
        d["roofline_fraction"] = self.roofline_fraction()
        return d


def model_flops_for_cell(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global MODEL_FLOPS for one step of this cell."""
    fwd_per_token = model_flops_per_token(cfg, cfg.lexi_plan)
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        return 3.0 * fwd_per_token * tokens          # fwd + 2x bwd = 6ND
    if shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return fwd_per_token * tokens                # 2ND forward-only
    # decode: one token per sequence
    return fwd_per_token * shape.global_batch


@dataclass
class CellCosts:
    """Per-rank cost triple of one step."""

    flops: float
    nbytes: float
    coll_bytes: Dict[str, float]

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def __sub__(self, o: "CellCosts") -> "CellCosts":
        keys = set(self.coll_bytes) | set(o.coll_bytes)
        return CellCosts(
            self.flops - o.flops, self.nbytes - o.nbytes,
            {k: self.coll_bytes.get(k, 0.0) - o.coll_bytes.get(k, 0.0)
             for k in keys})

    def scaled_add(self, o: "CellCosts", c: float) -> "CellCosts":
        keys = set(self.coll_bytes) | set(o.coll_bytes)
        return CellCosts(
            self.flops + max(o.flops, 0.0) * c,
            self.nbytes + max(o.nbytes, 0.0) * c,
            {k: self.coll_bytes.get(k, 0.0)
             + max(o.coll_bytes.get(k, 0.0), 0.0) * c for k in keys})


def costs_from_counters(counts) -> CellCosts:
    """A step's ``analysis.counters.Counts`` as its cost triple."""
    return CellCosts(float(counts.flops), float(counts.nbytes),
                     {k: float(v) for k, v in
                      counts.collectives.bytes_by_kind.items()})


def device_memory(counts) -> float:
    """The step's peak live bytes on the rank (``Counts.peak_bytes``)."""
    return float(counts.peak_bytes)


def analyze_costs(
    costs: CellCosts,
    cfg: ModelConfig,
    shape: ShapeSpec,
    *,
    chips: int,
    mesh_desc: str,
    hw: Dict = HW,
    bytes_per_device: Optional[float] = None,
    note: str = "",
) -> RooflineReport:
    t_c = costs.flops / hw["peak_flops"]
    t_m = costs.nbytes / hw["hbm_bw"]
    t_x = costs.coll_total / _link_bw(hw)
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    mf = model_flops_for_cell(cfg, shape)
    ratio = mf / max(costs.flops * chips, 1.0)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_desc, chips=chips,
        hlo_flops=costs.flops, hlo_bytes=costs.nbytes,
        collective_bytes=costs.coll_total,
        collective_breakdown={k: int(v) for k, v in costs.coll_bytes.items()},
        t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dom,
        model_flops_global=mf, useful_flops_ratio=ratio,
        bytes_per_device=bytes_per_device, note=note,
        peak_flops=hw["peak_flops"],
    )


def save_report(report: RooflineReport, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=1)
