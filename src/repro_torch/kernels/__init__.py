"""Hand-written GPU kernels and their plain PyTorch versions.

Layout as in ``repro.kernels``: ``<name>.py`` (build, binding, wrapper and
launch count of ``csrc/<name>.cu``) + ``ref.py`` (plain torch) + ``ops.py``
(dispatch: CUDA tensors to the kernel, CPU tensors to ``ref``).
Importing this package builds nothing.
"""
