"""Training entry point of the port (port of ``repro/launch/train.py``):
the fault-tolerant loop on one device, the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 200 --reduced --device cpu --ckpt /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 8

float32 weights, AdamW (warmup ``min(20, steps // 10 + 1)``), no remat, as
the reference's launcher.  It refuses what the port does not train: an
``embed_input=False`` arch (the loop has no embeddings to feed) and a mesh.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    """Returns the loop's (model, optimizer state, losses of this run)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt in "
                         "the temp directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced-width config (CPU-friendly)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_arch
    from ..train import (AdamWConfig, DataConfig, LoopConfig, TrainOptions,
                         train)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=128, n_heads=4, vocab=1024)
    print(f"[train] {cfg.name}: ~{cfg.n_params() / 1e6:.1f}M params")
    acfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                       total_steps=args.steps)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab)
    lcfg = LoopConfig(total_steps=args.steps,
                      ckpt_dir=args.ckpt or LoopConfig.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=10)
    opts = TrainOptions(remat=False, microbatches=args.microbatches)
    model, opt_state, hist = train(cfg, acfg, dcfg, lcfg, opts=opts,
                                   dtype=torch.float32, device=args.device)
    if hist:
        print(f"[train] done: loss {hist[0]:.4f} → {hist[-1]:.4f}")
    return model, opt_state, hist


if __name__ == "__main__":
    main()
