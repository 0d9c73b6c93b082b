"""repro_torch: the RLTune scheduler on PyTorch and CUDA.

Mirrors the ``repro`` package module for module.  Host logic (trace
generation, cluster state, features, MILP placement, the event loop) is
numpy/scipy carried over unchanged; the device side is the PPO actor/critic
in torch, whose per-job actor MLP runs through a hand-written CUDA kernel
(``repro_torch.kernels.policy_mlp``) on the GPU.
"""
