"""The Vertica engine ported to PyTorch and CUDA for NVIDIA Hopper (H100).

A second package beside ``repro`` (the JAX/Pallas reference), with the
same layout -- ``core/``, ``planner/``, ``engine/``, ``kernels/``,
``data/`` -- so each module's counterpart is found by name.  It imports
``torch`` and numpy, never jax and nothing of ``repro``.  A database runs
on ``device="cuda"`` unless the caller asks for the CPU.
"""
