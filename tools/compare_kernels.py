#!/usr/bin/env python3
"""Time the policy-MLP, SSD-scan and MoE-router kernels of several checkouts
on one card.

    python3 tools/compare_kernels.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example a parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``).  The
roots run one after another, each in a process of its own that imports that
checkout's ``repro_torch``, builds its kernels and times them on the same
seeded inputs: ``policy_mlp`` on the actor's 8 -> 64 -> 32 -> 1 net at the
queue depths of ``chip_smoke.py`` phase 3 and the tail buckets of its main
path, ``ssd_scan`` at every SSD case of ``chip_smoke.py`` phase 13, and
``moe_router`` at every router case of phase 13 (each registered (d, E, k)
at decode T 4 and prefill T 8,192, f32 and bf16).
Times are device µs per call from CUDA-graph replay
(``chip_smoke.graph_ms``); every result is also held against the plain
version at ``chip_smoke.py``'s tolerances.  Give the roots in turns (A B B
A) to see how far the card drifts between runs.  Needs one CUDA card and
``nvcc``; prints the card's name and power limit, one JSON line per root
and case, and a table.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
POLICY_QS = (256, 300, 512, 1024, 2048, 2304, 4096, 16384)
# the registered router shapes (d, E, k): jamba, granite, qwen3
ROUTERS = ((4096, 16, 2), (1024, 32, 8), (4096, 128, 8))


def cases():
    """(kernel, case) pairs in a fixed order: policy Q; SSD (B, L, H, P, N,
    init, dtype name) and router (T, d, E, k, dtype name) as chip_smoke.py
    phase 13 runs them."""
    out = [("policy_mlp", (Q,)) for Q in POLICY_QS]
    for shape, init in (((4, 2048, 128, 64, 16), False),
                        ((1, 2048, 48, 64, 128), True),
                        ((1, 200, 48, 64, 128), True)):
        for dtype in ("bfloat16", "float32"):
            out.append(("ssd_scan", shape + (init, dtype)))
    for d, E, k in ROUTERS:
        for T in (4, 8192):
            for dtype in ("bfloat16", "float32"):
                out.append(("moe_router", (T, d, E, k, dtype)))
    return out


def one(root: Path) -> None:
    """Time every case with the kernels of checkout ``root``."""
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from chip_smoke import ATOL, LM_TOL, graph_ms, router_check
    from repro_torch.kernels import moe_router as mr, policy_mlp as pm
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import policy_mlp_ref, ssd_scan_ref

    assert Path(pm.__file__).resolve().is_relative_to(root.resolve())
    pm.build()
    ss.build()
    mr.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed, (kernel, case) in enumerate(cases()):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def randn(shape, dtype=torch.float32, scale=1.0):
            return (torch.randn(shape, device=dev, generator=gen)
                    * scale).to(dtype)
        if kernel == "policy_mlp":
            (Q,) = case
            flat = [randn(s) for s in ((8, 64), (64,), (64, 32), (32,),
                                       (32, 1), (1,))]
            x = randn((Q, 8))
            mask = (randn((Q,)) > 0).float()
            err = float((pm.policy_mlp(x, *flat, mask)
                         - policy_mlp_ref(x, *flat, mask)).abs().max())
            ok = err <= ATOL
            us = graph_ms(lambda: pm.policy_mlp(x, *flat, mask)) * 1e3
        elif kernel == "moe_router":
            T, d, E, k, name = case
            x = randn((T, d), getattr(torch, name))
            w = randn((d, E), scale=0.1 / d ** 0.5)
            got_w, got_i = mr.moe_router(x, w, k)
            try:
                err, ok = router_check(x, w, k, got_w, got_i), True
            except RuntimeError:
                err, ok = float("nan"), False
            us = graph_ms(lambda: mr.moe_router(x, w, k)) * 1e3
        else:
            B, L, H, P, N, init, name = case
            dtype = getattr(torch, name)
            xh = randn((B, L, H, P), dtype, 0.5)
            dt = F.softplus(randn((B, L, H)))
            A = -torch.exp(randn((H,), scale=0.3))
            Bs, Cs = randn((B, L, N), dtype, 0.3), randn((B, L, N), dtype, 0.3)
            S0 = randn((B, H, P, N), scale=0.3) if init else None
            y, S = ss.ssd_scan(xh, dt, A, Bs, Cs, S0)
            y_want, S_want = ssd_scan_ref(xh, dt, A, Bs, Cs, S0)
            tol = LM_TOL[name]["ssd_scan"]
            d = (y.float() - y_want.float()).abs()
            ok = bool((d <= tol + tol * y_want.float().abs()).all()
                      and ((S - S_want).abs()
                           <= 2e-3 + 2e-3 * S_want.abs()).all())
            err = max(float(d.max()), float((S - S_want).abs().max()))
            us = graph_ms(lambda: ss.ssd_scan(xh, dt, A, Bs, Cs, S0),
                          calls=5, replays=5) * 1e3
            del xh, Bs, Cs, y, y_want
        print(json.dumps({"root": str(root), "kernel": kernel,
                          "case": list(case), "us": us, "max_abs_err": err,
                          "ok": ok}), flush=True)
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        one(Path(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    table: dict[tuple, list[str]] = {}
    bad = 0
    for i, root in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            rec = json.loads(line)
            print(line)
            bad += not rec["ok"]
            key = (rec["kernel"], tuple(rec["case"]))
            table.setdefault(key, [""] * len(argv))[i] = f"{rec['us']:.3f}"
    print(f"device us per call ({smi}); roots in order: {' | '.join(argv)}")
    for (kernel, case), times in table.items():
        print(f"{kernel} {case}: {' | '.join(times)}")
    if bad:
        print(f"compare_kernels: {bad} results outside the tolerance",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
