"""The examples of ``examples/`` on the PyTorch/CUDA port: each runs on the
card by default (``--device cuda``; ``--device cpu`` on request) and
exposes ``main(argv=None)``, which returns what it prints."""
