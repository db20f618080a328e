"""quant_tpu_torch — the PyTorch/CUDA port of quant_tpu for NVIDIA Hopper.

The JAX package ``quant_tpu`` is the reference; this package imports nothing
of it. Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``. The hot ops are hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` on first use (``kernels/_build.py``).
"""

__version__ = "0.1.0"
