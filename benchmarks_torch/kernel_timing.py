"""Device time of a kernel call, the least time the H100 could take for
the same work, and the tolerances a kernel is held to: the one source of
them for ``bench_kernels``, ``chip_smoke.py`` and the tools.

``graph_ms`` times a call by CUDA-graph replay, so host dispatch does not
enter.  Each ``*_bound`` returns (ms, "operations" | "bytes"): the larger
of the operations the call must do (2 per multiply-add) over the card's
peak rate for their type and of its bytes (each input read once, each
output written once) over the memory rate.  ``ATOL``, ``LM_TOL`` and
``router_check`` hold a kernel's result against its plain version.
Rates: the H100 SXM data sheet (989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32 outside them, 3.35 TB/s HBM3).  Imports torch and
``repro_torch`` only when called.
"""
from __future__ import annotations

# a kernel against its plain version: the two MLPs (abs), the LM kernels
# (abs + rel: |got - want| <= tol + tol |want|); the SSD's final state 2e-3
# in either dtype; the router's weights 1e-5 (``router_check``)
ATOL = 1e-5
LM_TOL = {"float32": {"flash_attention": 2e-5, "ssd_scan": 2e-3},
          "bfloat16": {"flash_attention": 2e-2, "ssd_scan": 2e-2}}

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured into a CUDA graph
    and replayed, so host-side dispatch does not enter the time."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def lm_bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _size(dtype) -> int:
    import torch
    return torch.tensor([], dtype=dtype).element_size()


def _peak(dtype) -> float:
    import torch
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS


def bound(Q: int, n_live: int, F: int, H1: int, H2: int) -> tuple[float, str]:
    """The fused policy MLP: the operations the unmasked rows need over
    the f32 peak, or every input read once and the output written once."""
    flops = 2.0 * (F * H1 + H1 * H2 + H2) * n_live
    nbytes = 4.0 * (Q * F + Q + Q + F * H1 + H1 + H1 * H2 + 2 * H2 + 1)
    return lm_bound(flops, nbytes, PEAK_F32_FLOPS)


def predict_bound(B: int, F: int, H1: int, H2: int, Q: int) -> tuple[float, str]:
    """The predictor MLP: its operations over the f32 peak, or every input
    read once and the output written once."""
    flops = 2.0 * (F * H1 + H1 * H2 + H2 * Q) * B
    nbytes = 4.0 * (B * F + B * Q + F * H1 + H1 + H1 * H2 + H2 + H2 * Q + Q)
    return lm_bound(flops, nbytes, PEAK_F32_FLOPS)


def flash_bound(B, H, KV, L, D, window, dtype) -> tuple[float, str]:
    """q.k and p.v over the (query, key) pairs the mask keeps (2 FLOP per
    multiply-add each), against q, k, v and o moved once."""
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(L))
    flops = 4.0 * B * H * D * pairs
    nbytes = _size(dtype) * B * L * D * (2 * H + 2 * KV)
    return lm_bound(flops, nbytes, _peak(dtype))


def ssd_bound(B, L, H, P, N, chunk, dtype) -> tuple[float, str]:
    """The chunked SSD's products at the reference's chunk: C.B^T per
    (batch, chunk), the lower-triangular W.x, the state's share C.S and
    the state update per (batch, head, chunk); against x, dt, B, C and y
    moved once and the final state written once."""
    Q = min(chunk, L)
    nc = L // Q
    flops = B * nc * (2.0 * Q * Q * N
                      + H * (Q * (Q + 1) * P + 4.0 * Q * P * N))
    nbytes = (_size(dtype) * (2 * B * L * H * P + 2 * B * L * N)
              + 4 * B * L * H + 4 * H + 4 * B * H * P * N)
    return lm_bound(flops, nbytes, _peak(dtype))


def router_bound(T, d, E, k, dtype) -> tuple[float, str]:
    """x.W in f32 (W is f32): f32 FMAs, or for bf16 x three exact bf16
    products on the tensor cores (W split in three bf16 parts), whichever
    the card does sooner; against x and W read once and the weights and
    indices written once (the top-k passes are negligible)."""
    import torch
    nbytes = _size(dtype) * T * d + 4 * d * E + 8 * T * k
    if dtype == torch.bfloat16:
        return lm_bound(3 * 2.0 * T * d * E, nbytes, PEAK_BF16_FLOPS)
    return lm_bound(2.0 * T * d * E, nbytes, PEAK_F32_FLOPS)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def router_check(x, w, k, got_w, got_i) -> float:
    """Where the k-th and (k+1)-th plain logits are more than 1e-4 apart,
    the kernel picks the same set of experts with weights within 1e-5 (in
    its order); where every gap among the top k + 1 exceeds 1e-4, the same
    experts in the same order.  Returns the weights' max abs error on the
    rows held."""
    import torch
    from repro_torch.kernels.ref import moe_router_ref
    want_w, want_i = moe_router_ref(x, w, k)
    E = w.shape[1]
    top = torch.sort(x.float() @ w, dim=-1, descending=True).values
    gaps = top[:, :min(k + 1, E)].diff(dim=-1).neg()
    set_sep = gaps[:, k - 1] > 1e-4 if k < E else torch.ones_like(top[:, 0],
                                                                 dtype=bool)
    ord_sep = (gaps > 1e-4).all(dim=-1)
    _check(bool(set_sep.float().mean() > 0.9) or len(set_sep) < 100,
           f"router: only {int(set_sep.sum())} of {len(set_sep)} rows separated")
    what = f"T={x.shape[0]} E={E} k={k}"
    _check(torch.equal(got_i[set_sep].sort(dim=-1).values,
                       want_i[set_sep].sort(dim=-1).values),
           f"router expert sets differ at {what}")
    _check(torch.equal(got_i[ord_sep], want_i[ord_sep]),
           f"router expert order differs at {what}")
    err = float((got_w - want_w)[set_sep].abs().max()) if bool(set_sep.any()) else 0.0
    _check(err <= 1e-5, f"router weights differ by {err:.3e} > 1e-5 at {what}")
    return err
