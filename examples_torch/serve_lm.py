"""Batched serving on the port with continuous batching + KV caches across
the model zoo (prefill -> decode; attention KV, SWA ring buffers, Mamba
states).

    PYTHONPATH=src python examples_torch/serve_lm.py --arch jamba-v0.1-52b [--device cpu]

The analog of ``examples/serve_lm.py``: the registered smoke config with
seeded random weights, served on ``--device`` (default the card, where
attention runs the ``flash_attention`` kernel and, for hybrid and MoE
configs such as ``jamba-v0.1-52b``, the ``ssd_scan`` and ``moe_router``
kernels; on the CPU their plain versions).  ``main`` returns the finished
requests.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model is served (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)   # the reduced config
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    engine = ServeEngine(model, params, batch_size=args.batch,
                         device=args.device)

    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i,
                    prompt=[int(t) for t in
                            rng.integers(1, cfg.vocab_size, size=12)],
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"[serve_lm] {args.arch} (smoke config): {len(done)} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s on "
          f"{args.device})")
    for r in done[:3]:
        print(f"  req{r.req_id}: {r.output}")
    return done


if __name__ == "__main__":
    main()
