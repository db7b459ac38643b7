"""Serving entry point of the port (port of ``repro/launch/serve.py``): bring up
the LM engine on a synthetic workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --solver lm \\
        --arch qwen3-1.7b --reduced --device cpu

runs on the CPU; without ``--device`` it runs on the card.  ``--solver amg``
(the reference's harness around ``AMGService`` and its AMGWire socket server)
is not ported yet; :class:`repro_torch.amg.AMGService` itself is.
"""
from __future__ import annotations

import argparse
import time


def run_lm(args):
    import numpy as np
    import torch

    from ..configs import get_arch
    from ..models import init_lm
    from ..serve import Engine, Request

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=128, n_heads=4, vocab=1024)
    model = init_lm(cfg, seed=0, dtype=torch.float32, device=args.device)
    eng = Engine(cfg, model, max_batch=args.batch,
                 ctx_len=args.prompt_len + args.new_tokens + 8,
                 device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len, dtype=np.int32),
            max_new_tokens=args.new_tokens,
            temperature=args.temperature))
    out = eng.run()
    dt = time.perf_counter() - t0
    s = eng.stats
    print(f"[serve] {len(out)} requests in {dt:.2f}s on {eng.device}; "
          f"prefill {s['prefill_s']:.2f}s; "
          f"decode {s['tokens'] / max(s['decode_s'], 1e-9):.1f} tok/s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", choices=("lm", "amg"), default="lm")
    ap.add_argument("--arch", help="LM architecture (required for --solver lm)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.solver == "amg":
        raise NotImplementedError(
            "--solver amg: the launcher's AMGService harness and the AMGWire "
            "server are not ported yet (ROADMAP queue 1 item 6); "
            "repro_torch.amg.AMGService serves in-process")
    if not args.arch:
        raise SystemExit("--solver lm requires --arch")
    return run_lm(args)


if __name__ == "__main__":
    main()
