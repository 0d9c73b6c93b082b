"""Serving driver: batched requests through prefill + greedy decode.

Smoke mode on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --smoke --device cpu --requests 8 --max-new 12
Without ``--device`` it runs on the GPU (``cuda``) and raises where there is
none.  Weights are random from a seeded generator.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import LM, ModelImpl
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = LM(cfg, impl=ModelImpl(), device=args.device)
    params = model.init(0)
    engine = ServeEngine(model, params, batch_size=args.batch,
                         device=args.device)

    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i,
                    prompt=[int(t) for t in rng.integers(1, cfg.vocab_size,
                                                         size=args.prompt_len)],
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    done = engine.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total_new = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s) on {model.device}")
    for r in done[:3]:
        print(f"  req{r.req_id}: {r.output}")


if __name__ == "__main__":
    main()
