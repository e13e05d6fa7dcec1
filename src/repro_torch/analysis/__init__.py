"""What a step costs: collective traffic (``collectives.py``, the
counterpart of the reference's ``analysis/hlo.py``), the step's FLOPs,
bytes and peak memory counted as it runs (``counters.py``) and the
three-term roofline against the H100 (``roofline.py``)."""

from repro_torch.analysis.collectives import (  # noqa: F401
    CollectiveStats,
    operand_bytes,
    record,
)
