"""PyTorch + CUDA port of the LExI serving stack (``repro``), for one
NVIDIA H100.

Module paths mirror ``src/repro/`` one for one.  The port imports
``torch`` and never ``jax`` or anything of ``repro``: what it needs of the
reference's pure-Python modules it keeps as its own copies.  Every kernel
the slice runs is a hand-written CUDA kernel under ``csrc/`` with its plain
PyTorch version beside it (``kernels/``).
"""
