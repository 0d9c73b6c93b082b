"""Hardware constants of one NVIDIA H100 SXM (the roofline denominators),
from NVIDIA's data sheet: dense rates without sparsity, at the full 700 W
power limit.  The mesh factories of the reference come with the
distribution slice.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12          # per card, bf16 on the tensor cores (dense)
HBM_BW = 3.35e12                  # bytes/s per card, HBM3
# NVLink 4 between the cards of a host: 900 GB/s per card both ways, 450
# GB/s each way.  It plays the part of the reference's per-link ICI rate.
NVLINK_BW = 450e9                 # bytes/s per card, one direction
