"""Kernel micro-benchmarks of the port: each of the five hand-written CUDA
kernels against its plain torch version, its bound on the H100 and, where
one PyTorch call computes the same function, that call.

    PYTHONPATH=src python -m benchmarks_torch.bench_kernels [--device cuda|cpu] [--smoke]

The analog of ``benchmarks/bench_kernels.py``: its three rows under its
names (``kernels/attention_ref_1k``: attention B 1, H 8, KV 2, L 1,024,
D 128, f32, causal, with the reference's derived TFLOP/s
``4 B H L^2 D / 2`` over the time; ``kernels/ssd_chunked_1k``: the SSD
scan B 1, L 1,024, H 4, P 64, N 128 against ``models.mamba.ssd_chunked``
at chunk 256; ``kernels/moe_router_4k``: the router T 4,096, d 256, E 64,
k 8), then one row per kernel at the main path's shapes: the policy MLP
(8 -> 64 -> 32 -> 1) at the tail buckets of the decision loop, Q 4,096
among them; the predictor MLP (21 -> 24 -> 12 -> 2) at B 2,560; bf16
attention at B 4, L 2,048, H 32, KV 8, D 128, causal; the SSD at B 4,
L 2,048, H 128, P 64, N 16 in bf16; the router at d 4,096, E 16, k 2,
decode T 4 and prefill T 8,192, f32 and bf16.

On the card (the default) every row gives the kernel's device µs by
CUDA-graph replay (``kernel_timing.graph_ms``), the plain version's
(``kernels/ref.py``, or ``ssd_chunked`` where the reference times that),
``scaled_dot_product_attention``'s for attention (the faster of grouped
and KV-repeated inputs; the other rows have no one PyTorch call), the
bound and what bounds it, the kernel's launches in the row and the
largest error against the plain version, held at ``kernel_timing``'s
tolerances (a failed check raises).  On ``--device cpu`` it times the
plain versions only, on the host clock, as the reference times its
oracles, and launches nothing; ``--smoke`` runs the reference's three
rows only.  The record goes to ``benchmarks_torch/BENCH_kernels.json``
(``REPRO_BENCH_KERNELS_JSON`` redirects), with the provenance of
``common.provenance()``, the card's name and power limit among it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

from benchmarks_torch.kernel_timing import (ATOL, LM_TOL, flash_bound,
                                            graph_ms, predict_bound,
                                            router_bound, router_check,
                                            ssd_bound)
from benchmarks_torch.kernel_timing import bound as policy_bound

JSON_PATH = os.environ.get(
    "REPRO_BENCH_KERNELS_JSON",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_kernels.json"))
#: the decision loop's tail buckets (``tools/compare_kernels.POLICY_QS``)
POLICY_QS = (256, 300, 512, 1024, 2048, 2304, 4096, 16384)
SSD_CHUNK = 256
KERNELS = ("policy_mlp", "predict_mlp", "flash_attention", "ssd_scan",
           "moe_router")
#: the keys of every row of the record
KEYS = ("name", "kernel", "shape", "dtype", "us", "plain_us", "plain",
        "library_us", "library", "bound_us", "bound_by", "launches",
        "max_abs_err", "tol", "derived")


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    kernel: str
    shape: dict
    dtype: str = "float32"
    reference: bool = False          # one of the reference's three rows


def cases() -> list[Case]:
    out = [
        Case("kernels/attention_ref_1k", "flash_attention",
             dict(B=1, H=8, KV=2, L=1024, D=128), reference=True),
        Case("kernels/ssd_chunked_1k", "ssd_scan",
             dict(B=1, L=1024, H=4, P=64, N=128), reference=True),
        Case("kernels/moe_router_4k", "moe_router",
             dict(T=4096, d=256, E=64, k=8), reference=True),
    ]
    out += [Case(f"kernels/policy_mlp_q{Q}", "policy_mlp",
                 dict(Q=Q, F=8, H1=64, H2=32)) for Q in POLICY_QS]
    out.append(Case("kernels/predict_mlp_b2560", "predict_mlp",
                    dict(B=2560, F=21, H1=24, H2=12, Q=2)))
    out.append(Case("kernels/flash_attention_serve", "flash_attention",
                    dict(B=4, H=32, KV=8, L=2048, D=128), "bfloat16"))
    out.append(Case("kernels/ssd_scan_serve", "ssd_scan",
                    dict(B=4, L=2048, H=128, P=64, N=16), "bfloat16"))
    for T, tag in ((4, "decode"), (8192, "prefill")):
        for dtype in ("float32", "bfloat16"):
            out.append(Case(f"kernels/moe_router_{tag}_{dtype}", "moe_router",
                            dict(T=T, d=4096, E=16, k=2), dtype))
    return out


def inputs(case: Case, device, seed: int) -> dict:
    """The case's inputs, drawn with numpy from ``seed`` (so the JAX
    oracles can take the same), as tensors on ``device``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    s = case.shape
    dtype = getattr(torch, case.dtype)

    def t(shape, scale=1.0, dt=dtype):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(device=device, dtype=dt)

    f32 = torch.float32
    if case.kernel == "flash_attention":
        return dict(q=t((s["B"], s["H"], s["L"], s["D"])),
                    k=t((s["B"], s["KV"], s["L"], s["D"])),
                    v=t((s["B"], s["KV"], s["L"], s["D"])))
    if case.kernel == "ssd_scan":
        B, L, H, P, N = (s[c] for c in "BLHPN")
        scale = 0.3 if case.reference else 0.5
        return dict(xh=t((B, L, H, P), scale),
                    dt=torch.nn.functional.softplus(t((B, L, H), dt=f32)),
                    A=-torch.exp(t((H,), 0.3, f32)),
                    Bs=t((B, L, N), 0.3), Cs=t((B, L, N), 0.3))
    if case.kernel == "moe_router":
        scale = 0.1 if case.reference else 0.1 / s["d"] ** 0.5
        return dict(x=t((s["T"], s["d"])), w=t((s["d"], s["E"]), scale, f32))
    if case.kernel == "policy_mlp":
        Q, F, H1, H2 = s["Q"], s["F"], s["H1"], s["H2"]
        flat = [t(shape) for shape in ((F, H1), (H1,), (H1, H2), (H2,),
                                       (H2, 1), (1,))]
        return dict(x=t((Q, F)), flat=flat,
                    mask=torch.from_numpy((rng.random(Q) < 0.5).astype(
                        np.float32)).to(device))
    B, F, H1, H2, Q = s["B"], s["F"], s["H1"], s["H2"], s["Q"]
    return dict(x=t((B, F)), flat=[t(shape) for shape in (
        (F, H1), (H1,), (H1, H2), (H2,), (H2, Q), (Q,))])


def plain(case: Case, a: dict):
    """The plain torch version of the case's function (what the kernel is
    held to and timed against)."""
    from repro_torch.kernels import ref
    if case.kernel == "flash_attention":
        return ref.flash_attention_ref(a["q"], a["k"], a["v"], causal=True)
    if case.kernel == "ssd_scan":
        if case.reference:
            from repro_torch.models.mamba import ssd_chunked
            return ssd_chunked(a["xh"], a["dt"], a["A"], a["Bs"], a["Cs"],
                               chunk=SSD_CHUNK, impl="xla")
        return ref.ssd_scan_ref(a["xh"], a["dt"], a["A"], a["Bs"], a["Cs"])
    if case.kernel == "moe_router":
        return ref.moe_router_ref(a["x"], a["w"], case.shape["k"])
    if case.kernel == "policy_mlp":
        return ref.policy_mlp_ref(a["x"], *a["flat"], a["mask"])
    return ref.predict_mlp_ref(a["x"], *a["flat"])


def _kernel_fn(case: Case, a: dict):
    from repro_torch.kernels import (flash_attention, moe_router, policy_mlp,
                                     predict_mlp, ssd_scan)
    if case.kernel == "flash_attention":
        return lambda: flash_attention.flash_attention(
            a["q"], a["k"], a["v"], causal=True)
    if case.kernel == "ssd_scan":
        return lambda: ssd_scan.ssd_scan(a["xh"], a["dt"], a["A"], a["Bs"],
                                         a["Cs"])
    if case.kernel == "moe_router":
        return lambda: moe_router.moe_router(a["x"], a["w"], case.shape["k"])
    if case.kernel == "policy_mlp":
        return lambda: policy_mlp.policy_mlp(a["x"], *a["flat"], a["mask"])
    return lambda: predict_mlp.predict_mlp(a["x"], *a["flat"])


def _library_fn(case: Case, a: dict):
    """``scaled_dot_product_attention`` on grouped and on KV-repeated
    inputs, for attention; None for the other kernels."""
    if case.kernel != "flash_attention":
        return None
    import torch.nn.functional as F
    q, k, v = a["q"], a["k"], a["v"]
    G = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    return (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True),
            lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True))


def _check(case: Case, a: dict, got, want) -> tuple[float, str]:
    """The kernel's result against the plain version's at the kernel's
    tolerance; returns (max abs error, the tolerance); raises outside it."""
    if case.kernel == "moe_router":
        return router_check(a["x"], a["w"], case.shape["k"], *got), \
            "weights 1e-5, experts where separated by 1e-4"
    if case.kernel in ("policy_mlp", "predict_mlp"):
        err = float((got - want).abs().max())
        if err > ATOL:
            raise RuntimeError(f"{case.name}: max abs err {err:.3e} > {ATOL}")
        return err, f"abs {ATOL}"
    tol = LM_TOL[case.dtype][case.kernel]
    pairs = [("out", got, want, tol)] if case.kernel == "flash_attention" \
        else [("y", got[0], want[0], tol), ("state", got[1], want[1], 2e-3)]
    err = 0.0
    for what, g, w, t in pairs:
        d = (g.float() - w.float()).abs()
        bad = int((d > t + t * w.float().abs()).sum())
        if bad:
            raise RuntimeError(f"{case.name} {what}: {bad} elements outside "
                               f"{t} (max abs err {float(d.max()):.3e})")
        err = max(err, float(d.max()))
    return err, (f"abs+rel {tol}" if case.kernel == "flash_attention"
                 else f"abs+rel {tol}, state 2e-3")


def _bound(case: Case, a: dict) -> tuple[float, str]:
    import torch
    s, dtype = case.shape, getattr(torch, case.dtype)
    if case.kernel == "flash_attention":
        return flash_bound(s["B"], s["H"], s["KV"], s["L"], s["D"], 0, dtype)
    if case.kernel == "ssd_scan":
        return ssd_bound(s["B"], s["L"], s["H"], s["P"], s["N"], SSD_CHUNK,
                         dtype)
    if case.kernel == "moe_router":
        return router_bound(s["T"], s["d"], s["E"], s["k"], dtype)
    if case.kernel == "policy_mlp":
        return policy_bound(s["Q"], int(a["mask"].sum()), s["F"], s["H1"],
                            s["H2"])
    return predict_bound(s["B"], s["F"], s["H1"], s["H2"], s["Q"])


# CUDA-graph replay sizes (calls, replays) of the kernel, plain and library
# calls: the LM kernels at the main path's shapes take hundreds of µs, their
# plain versions milliseconds
_GRAPH = {"flash_attention": ((5, 5), (2, 3)), "ssd_scan": ((5, 5), (1, 3))}


def _cpu_us(fn, n: int = 5) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def bench_case(case: Case, device, seed: int) -> dict:
    """One row: on the card the kernel held against its plain version and
    everything timed; on the CPU the plain version timed."""
    import torch
    from repro_torch.kernels import (flash_attention, moe_router, policy_mlp,
                                     predict_mlp, ssd_scan)
    mod = dict(flash_attention=flash_attention, moe_router=moe_router,
               policy_mlp=policy_mlp, predict_mlp=predict_mlp,
               ssd_scan=ssd_scan)[case.kernel]
    a = inputs(case, device, seed)
    b_ms, b_by = _bound(case, a)
    plain_name = ("models.mamba.ssd_chunked" if case.reference
                  and case.kernel == "ssd_scan" else
                  f"kernels.ref.{case.kernel}_ref")
    row = dict(name=case.name, kernel=case.kernel, shape=dict(case.shape),
               dtype=case.dtype, plain=plain_name, bound_us=b_ms * 1e3,
               bound_by=b_by, library=None, library_us=None)
    if torch.device(device).type != "cuda":
        with torch.no_grad():
            row.update(us=None, launches=0, max_abs_err=None, tol=None,
                       plain_us=_cpu_us(lambda: plain(case, a)))
        return row
    fn = _kernel_fn(case, a)
    (kc, kr), (pc, pr) = _GRAPH.get(case.kernel, ((50, 20), (50, 20)))
    start = mod.launches
    with torch.no_grad():
        err, tol = _check(case, a, fn(), plain(case, a))
        row.update(us=graph_ms(fn, kc, kr) * 1e3, max_abs_err=err, tol=tol,
                   launches=mod.launches - start,
                   plain_us=graph_ms(lambda: plain(case, a), pc, pr) * 1e3)
        lib = _library_fn(case, a)
        if lib is not None:
            row.update(library="scaled_dot_product_attention", library_us=min(
                graph_ms(f, kc, kr) for f in lib) * 1e3)
    torch.cuda.empty_cache()
    return row


def _derived(row: dict) -> str:
    us = row["us"] if row["us"] is not None else row["plain_us"]
    if row["name"] == "kernels/attention_ref_1k":
        s = row["shape"]
        flops = 4 * s["B"] * s["H"] * s["L"] * s["L"] * s["D"] * 0.5
        return f"{flops / us * 1e6 / 1e12:.3f}TF/s"
    if row["us"] is None:
        return f"plain {row['plain']} (host)"
    lib = "" if row["library_us"] is None else \
        f" library {row['library_us']:.1f}us"
    return (f"plain {row['plain_us']:.1f}us{lib} bound "
            f"{row['bound_us']:.3f}us ({row['bound_by']}) launches "
            f"{row['launches']}")


def run(out: list[str], device: str | None = None,
        smoke: bool = False) -> dict:
    """Every row (the reference's three with ``smoke``) on ``device``
    (default ``REPRO_BENCH_DEVICE``, else the card); appends the CSV rows
    to ``out``, writes ``JSON_PATH`` and returns the record."""
    import torch

    from benchmarks_torch.common import (bench_device, provenance, row,
                                         write_json)
    device = device or bench_device()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    prov = provenance(seed=0, device=device)
    print(f"# kernel microbenches ({'card: kernel, plain and library by '
          'CUDA-graph replay' if on_card else 'host: plain versions'})")
    if prov["nvidia_smi"]:
        print(prov["nvidia_smi"])
    rows = []
    for seed, case in enumerate(c for c in cases()
                                if c.reference or not smoke):
        r = bench_case(case, device, seed)
        r["derived"] = _derived(r)
        rows.append(r)
        us = r["us"] if on_card else r["plain_us"]
        print(f"  {case.name:34s} {us:12.2f}us  {r['derived']}", flush=True)
        out.append(row(case.name, us, r["derived"]))
    doc = {"provenance": prov, "device": device, "rows": rows}
    write_json(JSON_PATH, doc)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="default REPRO_BENCH_DEVICE, else cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's three rows only")
    args = ap.parse_args(argv)
    if args.device:
        from benchmarks_torch.common import DEVICE_ENV
        os.environ[DEVICE_ENV] = args.device
    out: list[str] = []
    run(out, smoke=args.smoke)
    for r in out:
        print(r)


if __name__ == "__main__":
    main()
