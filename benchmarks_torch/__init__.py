"""Benchmarks of the PyTorch/CUDA port (``src/repro_torch``).

Each module runs as ``python -m benchmarks_torch.<name>`` from the repo root
with ``PYTHONPATH=src``, defaults to the CUDA card, and imports nothing of
JAX or of the ``repro`` package.
"""
