"""PyTorch/CUDA port of the FUnc-SNE package ``repro``.

The JAX package stays the reference; this package mirrors its layout
(``repro_torch.core.funcsne`` is the counterpart of ``repro.core.funcsne``)
and runs its main path on an NVIDIA Hopper card through hand-written CUDA
kernels (``repro_torch/csrc``).  Every kernel wrapper runs the plain
PyTorch version for a CPU tensor and the CUDA kernel for a CUDA tensor.

It imports ``torch`` and numpy only: never ``jax`` and nothing of ``repro``.
"""
