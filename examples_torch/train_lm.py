"""End-to-end LM training on the port through the full stack: model zoo
config -> train_step -> AdamW -> deterministic data pipeline -> async
checkpoints -> restart.

    PYTHONPATH=src python examples_torch/train_lm.py                 # ~15M params, quick
    PYTHONPATH=src python examples_torch/train_lm.py --full          # ~100M, few hundred steps

The analog of ``examples/train_lm.py``, on ``--device`` (default the card;
``cpu`` on request).  Training takes the plain path, as the reference
trains: no hand-written kernel has a backward.  Loss on the synthetic
Markov stream drops well below ln(V) uniform entropy.  ``main`` returns
``train_loop``'s output.
"""
import argparse
import math
import tempfile

from repro_torch.configs.base import ModelConfig, register
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model

QUICK = ModelConfig(
    name="example-15m", family="dense",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
    d_ff=1024, vocab_size=2048, head_dim=32, tie_embeddings=True,
)
FULL = ModelConfig(
    name="example-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
    d_ff=3072, vocab_size=8192, head_dim=64, tie_embeddings=True,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 300 steps (slow on CPU)")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)

    cfg = FULL if args.full else QUICK
    register(cfg, cfg)  # make it addressable through the config registry
    steps = args.steps or (300 if args.full else 60)

    n = build_model(cfg, device=args.device).param_count()
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params, {steps} steps on "
          f"{args.device}")

    with tempfile.TemporaryDirectory() as ckpt:
        out = train_loop(cfg.name, smoke=False, steps=steps, batch=8,
                         seq=256, microbatches=2, ckpt_dir=ckpt,
                         ckpt_interval=max(steps // 3, 10), log_every=10,
                         lr=3e-3, device=args.device)
    first, last = out["losses"][0], out["final_loss"]
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} "
          f"(uniform entropy {math.log(cfg.vocab_size):.2f})")
    assert last < first, "training must reduce loss"
    return out


if __name__ == "__main__":
    main()
