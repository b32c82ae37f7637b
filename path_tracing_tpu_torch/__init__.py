"""PyTorch + CUDA port of the path_tracing_tpu renderer.

Same layout as ``path_tracing_tpu``; imports ``torch`` and never ``jax``.
The hot path of unidirectional PT runs hand-written CUDA kernels
(``csrc/pt_kernels.cu``) on an NVIDIA Hopper card; every kernel has a plain
PyTorch version beside it, which is what CPU tensors take.
"""
__version__ = "0.1.0"
