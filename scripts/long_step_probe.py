"""Probe the seq-2048 training steps carried on from the periodic run's
state, on one card: whether the loss jump seen there comes from
``chunked_attention``, from remat, or from the carried AdamW state.

qwen3-1.7b in f32 (TF32 off) at full width and depth is trained as
``chip_smoke.py``'s periodic step trains it (PERIODIC_STEPS steps, batch 8
x seq 256, one PERIOD-token sequence repeated, AdamW lr 3e-4 with one
warmup step).  Its parameters and moments are kept on the host, and each
variant starts from them and takes LONG_STEPS steps of batch 2 x seq 2048
on the same file with AdamW(warmup_steps=1, total_steps=LONG_STEPS), as the
smoke once did:

- ``chunked, remat``: the train forward's attention past 1024 keys
  (``chunked_attention``), each layer under remat;
- ``chunked, no remat``;
- ``plain, remat``: ``chunked_attention`` swapped for the plain softmax
  attention over all 2048 keys;
- ``chunked, remat, zeroed moments``: the carried parameters and step
  count (so the same lr), AdamW's moments zeroed;
- ``chunked, remat, fresh AdamW``: the carried parameters, AdamW's state
  new (count 0, so the first step takes the full lr 3e-4);
- ``chunked, remat, AdamW a step behind``: the carried parameters with
  AdamW's state from before the periodic run's last step;
- ``seq 256 on``: the carried state on the periodic run's own next batches
  (8 x 256), with the seq-2048 run's optimizer settings.

Each step prints its loss (before the update), grad norm and lr, then the
loss of the step's own batch after the update, and the update's largest
element over lr.  The numbers as one JSON line, then ``OK``::

    python3 scripts/long_step_probe.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

VARIANTS = (  # name, seq, remat, plain attention, AdamW state
    ("chunked, remat", 2048, True, False, "carried"),
    ("chunked, no remat", 2048, False, False, "carried"),
    ("plain, remat", 2048, True, True, "carried"),
    ("chunked, remat, zeroed moments", 2048, True, False, "zeroed"),
    ("chunked, remat, fresh AdamW", 2048, True, False, "fresh"),
    ("chunked, remat, AdamW a step behind", 2048, True, False, "behind"),
    ("seq 256 on", 256, False, False, "carried"),
)


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("long_step_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm
    from repro_torch.models.model import loss_fn
    from repro_torch.train import (AdamWConfig, DataConfig, TokenPipeline,
                                   TrainOptions, init_opt_state, make_step_fn)
    from repro_torch.train.train_step import to_device

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = cs.DEVICE
    cfg = get_arch(cs.TRAIN_ARCH)
    out: dict = {"arch": cfg.name}

    with tempfile.TemporaryDirectory(prefix="probe-") as tmp:
        path = cs.periodic_tokens(f"{tmp}/periodic.bin", cfg.vocab)
        pipes = {s: TokenPipeline(DataConfig(seq_len=s, global_batch=b,
                                             vocab=cfg.vocab, token_file=path))
                 for s, b in ((256, 8), (2048, cs.LONG_BATCH))}
        model = init_lm(cfg, seed=cs.SEED, dtype=torch.float32, device=dev,
                        trainable=True)
        params = dict(model.named_parameters())
        opt = init_opt_state(params)
        step = make_step_fn(cfg, AdamWConfig(warmup_steps=1,
                                             total_steps=cs.PERIODIC_STEPS),
                            TrainOptions(remat=False))
        def host(tree):
            return {n: t.detach().to("cpu", copy=True) for n, t in tree.items()}

        plosses, kept = [], {}
        for i in range(cs.PERIODIC_STEPS):
            if i == cs.PERIODIC_STEPS - 1:
                kept["behind"] = {"m": host(opt["m"]), "v": host(opt["v"]),
                                  "count": opt["count"].clone()}
            model, opt, m = step(model, opt, to_device(pipes[256].batch_at(i), dev))
            plosses.append(float(m["loss"]))
        out["periodic_losses"] = plosses
        print(f"periodic run: losses {[round(x, 4) for x in plosses]}", flush=True)
        kept["carried"] = {"m": host(opt["m"]), "v": host(opt["v"]),
                           "count": opt["count"].clone()}
        kept["zeroed"] = {"count": opt["count"].clone()}
        kept["fresh"] = {}
        keep = host(params)
        del opt
        acfg = AdamWConfig(warmup_steps=1, total_steps=cs.LONG_STEPS)
        for name, seq, remat, plain, state in VARIANTS:
            t0 = time.perf_counter()
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(keep[n])
            opt = init_opt_state(params)
            for k, v in kept[state].items():
                opt[k] = (v.clone() if k == "count" else
                          {n: t.to(dev, copy=True) for n, t in v.items()})
            vstep = make_step_fn(cfg, acfg, TrainOptions(remat=remat))
            first = cs.PERIODIC_STEPS if seq == 256 else 0
            rows = []
            chunked = attention.chunked_attention
            if plain:
                attention.chunked_attention = cs.plain_attention
            try:
                for i in range(cs.LONG_STEPS):
                    batch = to_device(pipes[seq].batch_at(first + i), dev)
                    before = {n: p.detach().clone() for n, p in params.items()}
                    model, opt, m = vstep(model, opt, batch)
                    moved = max(float((p.detach() - before[n]).abs().max())
                                for n, p in params.items())
                    del before
                    with torch.no_grad():
                        after = float(loss_fn(model, cfg, batch, use_kernel=False))
                    rows.append({"loss": float(m["loss"]),
                                 "grad_norm": float(m["grad_norm"]),
                                 "lr": float(m["lr"]), "loss_after": after,
                                 "max_update_over_lr": moved / float(m["lr"])})
            finally:
                attention.chunked_attention = chunked
            out[name] = {"steps": rows, "s": time.perf_counter() - t0}
            print(f"{name} (seq {seq}): " + "; ".join(
                f"loss {r['loss']:.4f} -> {r['loss_after']:.4f} after, grad norm "
                f"{r['grad_norm']:.4g}, lr {r['lr']:.3g}, max update "
                f"{r['max_update_over_lr']:.3g} lr" for r in rows), flush=True)
            del opt
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
