#!/usr/bin/env python3
"""Time each route of the MoE-router kernels on one card, to place their
crossovers.

    python3 tools/router_routes.py

For every registered router shape (d, E, k), f32 and bf16 x, and T from 1
to 8,192, it forces each route that takes the call (``split``, ``tiled``,
and ``mma`` for bf16 x) through ``moe_router.run``, holds the result
against the plain version (``kernel_timing.router_check``) and times it
(device µs per call from CUDA-graph replay, ``kernel_timing.graph_ms``).  It
prints one line per case with every route's time and the route the library
picks, then, per shape and dtype, the largest T at which ``split`` is the
fastest route.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TS = (1, 4, 64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 4096, 8192)
ROUTERS = ((4096, 16, 2), (1024, 32, 8), (4096, 128, 8))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("router_routes: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from benchmarks_torch.kernel_timing import graph_ms, router_check
    from chip_smoke import nvidia_smi_line
    from repro_torch.kernels import moe_router as mr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(nvidia_smi_line(), flush=True)
    mr.build()
    for d, E, k in ROUTERS:
        w = torch.randn((d, E), device=dev, generator=gen) * 0.1 / d ** 0.5
        for dtype in (torch.bfloat16, torch.float32):
            routes = ["split", "tiled"] + (["mma"] if dtype == torch.bfloat16
                                           else [])
            split_best = 0
            for T in TS:
                x = torch.randn((T, d), device=dev, generator=gen).to(dtype)
                us = {}
                for r in routes:
                    got_w, got_i = mr.run(x, w, k, r)
                    router_check(x, w, k, got_w, got_i)
                    us[r] = graph_ms(lambda: mr.run(x, w, k, r), calls=20,
                                     replays=10) * 1e3
                if min(us, key=us.get) == "split":
                    split_best = T
                print(f"d,E,k={d},{E},{k} {str(dtype)[6:]} T={T} "
                      + " ".join(f"{r}={t:.2f}us" for r, t in us.items())
                      + f" library_route={mr.route(T, d, E, dtype)}",
                      flush=True)
            print(f"d,E,k={d},{E},{k} {str(dtype)[6:]}: split is fastest "
                  f"up to T={split_best} of {TS}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
