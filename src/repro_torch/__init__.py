"""PyTorch/CUDA port of the StreamDCIM reproduction (counterpart of ``repro``).

The package mirrors ``repro``'s layout (``core/``, ``configs/``, ``plan/``,
``kernels/``, ``models/``) and imports nothing of it: what it needs from the
JAX package it keeps as its own copy.  Tensors on a CUDA device go through
the hand-written Hopper kernels in ``csrc/``; tensors on the CPU go through
each kernel's plain PyTorch version (the CPU tests use that path).
"""
