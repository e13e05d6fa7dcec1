"""Collective traffic accounting (``collectives.py``, the counterpart of
the reference's ``analysis/hlo.py``)."""

from repro_torch.analysis.collectives import (  # noqa: F401
    CollectiveStats,
    operand_bytes,
    record,
)
