"""PyTorch port of the aggregated asynchronous checkpointing runtime.

Counterpart of the JAX package ``repro``, module for module
(``repro_torch/core/plan.py`` is the port of ``repro/core/plan.py``).
It imports torch and NumPy only, never JAX or ``repro``. Entry points
run on the CUDA device unless the caller asks for the CPU
(``CheckpointConfig(device="cpu")``).
"""
__version__ = "0.1.0"
