"""repro_torch: the RLTune scheduler on PyTorch and CUDA.

Mirrors the ``repro`` package module for module.  Host logic (trace
generation, cluster state, features, MILP placement, the event loop, the
streaming service, and the control plane: preemption and migration
(``lifecycle``), autoscaling (``scale``), federation (``fed``) and
observability (``obs``)) is numpy/scipy carried over unchanged; the device
side is the PPO actor/critic and the runtime predictor's batched forward in
torch, whose MLPs run through hand-written CUDA kernels
(``repro_torch.kernels.policy_mlp``, ``predict_mlp``) on the GPU.  The LM
workload stack serves (``configs``, ``models``, ``serve``,
``launch.serve``: prefill and greedy decode for every registered config)
with flash attention, the Mamba2 SSD scan and the MoE router as
hand-written CUDA kernels (``kernels.flash_attention``, ``ssd_scan``,
``moe_router``); LM training (``data``, ``train``, ``ckpt``,
``launch.train``) runs on one card or, sharded as DTensors by the
reference's logical-axis rules (``sharding``), on a mesh, with the int8
compressed all-reduce and GPipe (``train.compression``, ``train.pipeline``),
the dry run of the production meshes on a fake process group
(``launch.dryrun``), and the cost model that turns it into platform job
runtimes (``core.costmodel``).
"""
