"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu`` for NVIDIA
Hopper (H100).

Each module mirrors the reference module at the same relative path under
``bigdl_tpu/``.  The port imports ``torch`` and numpy, never JAX and never
the reference package.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU; a CUDA tensor goes through the port's
hand-written kernels, a CPU tensor through their plain PyTorch versions.
"""

__version__ = "0.1.0"
