"""Serving entry point of the port (port of ``repro/launch/serve.py``): bring up
an engine and drain a synthetic workload, or serve AMGWire on a socket.

* ``--solver lm`` (default) — the LM generation engine, dense, MoE
  (``mixtral-8x22b``, ``qwen3-moe-235b-a22b``) or recurrent (``xlstm-125m``:
  mLSTM and sLSTM; ``recurrentgemma-9b``: RG-LRU and local attention at head
  dim 256); ``--layers`` cuts the depth (neither MoE arch fits one card
  whole: mixtral-8x22b's 56 layers hold 141 B parameters)::

      PYTHONPATH=src python -m repro_torch.launch.serve --solver lm \\
          --arch qwen3-1.7b --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \\
          --layers 2
      PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
      PYTHONPATH=src python -m repro_torch.launch.serve --arch phi-3-vision-4.2b

  An embedding-input arch (``musicgen-medium``, ``phi-3-vision-4.2b``) is
  fed the stub frontend's embeddings, standard normals drawn from
  ``--seed`` with numpy.

* ``--solver amg`` — :class:`~repro_torch.amg.api.AMGService`: solve requests
  admitted through tickets, same-(matrix, knobs) right-hand sides coalesced
  into one multi-RHS solve (on the card: the captured ``*_m`` graphs).
  ``--coalesce-window`` (seconds, > 0) runs the background admission worker;
  ``--wire`` drives the service purely through the versioned wire codec::

      PYTHONPATH=src python -m repro_torch.launch.serve --solver amg --wire \\
          --n-pods 2 --lanes 4 --n 10 --coalesce-window 0.2

* ``--solver amg --listen HOST:PORT`` — the AMGWire socket server
  (:class:`~repro_torch.serve.server.AMGWireServer`), each ``--tenant
  NAME[:MAX_INFLIGHT[:MAX_MATRIX_BYTES]]`` with its own service, session
  store and quotas::

      PYTHONPATH=src python -m repro_torch.launch.serve --solver amg \\
          --listen 127.0.0.1:0 --tenant alpha:32 --tenant beta:2

``--amg-backend`` is ``torch`` by default; like the LM engine it runs on the
card and refuses to start without one unless given ``--device cpu``.
``--amg-backend host`` runs the numpy reference solve.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

# the AMG harness's bar on a bfloat16 session's float64 true residual
BF16_TRUE_RESIDUAL = 2.0**-5


def run_lm(args):
    import numpy as np
    import torch

    from ..configs import get_arch
    from ..models import init_lm
    from ..serve import Engine, Request

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=128, n_heads=4, vocab=1024)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = init_lm(cfg, seed=0, dtype=torch.float32, device=args.device)
    eng = Engine(cfg, model, max_batch=args.batch,
                 ctx_len=args.prompt_len + args.new_tokens + 8,
                 device=args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        if cfg.embed_input:
            prompt = rng.integers(0, cfg.vocab, args.prompt_len, dtype=np.int32)
        else:   # the stub frontend's embeddings
            prompt = rng.standard_normal((args.prompt_len, cfg.d_model)) \
                .astype(np.float32)
        eng.submit(Request(
            rid=rid, prompt=prompt,
            max_new_tokens=args.new_tokens,
            temperature=args.temperature))
    out = eng.run()
    dt = time.perf_counter() - t0
    s = eng.stats
    print(f"[serve] {len(out)} requests in {dt:.2f}s on {eng.device}; "
          f"prefill {s['prefill_s']:.2f}s; "
          f"decode {s['tokens'] / max(s['decode_s'], 1e-9):.1f} tok/s")
    return out


def _amg_config(args):
    from ..amg.api import AMGConfig
    from ..serve.workload import default_tol

    tol = default_tol(args.amg_backend, args.tol, args.dtype)
    return AMGConfig(backend=args.amg_backend, n_pods=args.n_pods,
                     lanes=args.lanes, tol=tol, dtype=args.dtype,
                     device=args.device)


def run_amg(args) -> dict:
    """The in-process harness: admit ``--requests`` solves against a small
    Laplacian family, check every result's relative residual; returns the
    service's stats with the worst residual."""
    import numpy as np

    from ..amg.api import AMGService
    from ..serve.workload import (build_problems, make_request,
                                  matrix_payloads, rel_residual)

    cfg = _amg_config(args)
    svc = AMGService(cfg, max_rhs=args.batch,
                     coalesce_window=args.coalesce_window)
    mats = build_problems(args.n)
    if args.wire:
        # wire-only operation: the matrix id IS the verified content
        # fingerprint of the encoded payload (one real JSON byte hop)
        for payload in matrix_payloads(mats).values():
            svc.register_wire(payload)
    else:
        for mid, A in mats.items():
            svc.register(mid, A)
    ids = sorted(mats)
    rng = np.random.default_rng(0)

    def admit(rid):
        mid = ids[rid % len(ids)]
        b, payload = make_request(rng, mats, mid, method=args.method,
                                  rid=rid)
        ticket = (svc.submit_wire(payload) if args.wire
                  else svc.submit(mid, b, method=args.method, rid=rid))
        return mid, b, ticket

    t0 = time.perf_counter()
    admitted = [admit(rid) for rid in range(args.requests)]
    if args.coalesce_window > 0:
        with svc:                       # background admission worker
            out = {t.rid: t.result(timeout=600) for _, _, t in admitted}
    else:
        out = svc.drain()
    dt = time.perf_counter() - t0
    worst = 0.0
    for mid, b, ticket in admitted:
        worst = max(worst, rel_residual(mats[mid], out[ticket.rid], b))
    s = svc.stats
    mode = "wire" if args.wire else "direct"
    print(f"[serve/amg] {len(out)} solves ({len(ids)} matrices, "
          f"backend={args.amg_backend}, {cfg.dtype}, {mode}, "
          f"window={args.coalesce_window}s) in {dt:.2f}s: "
          f"{len(out) / dt:.1f} solves/s, {s['batches']} batches "
          f"({s['batched_rhs']} RHS batched, {s['wire_requests']} wire), "
          f"{s['setups']} setups, {s['unconverged']} unconverged, "
          f"worst rel residual {worst:.2e}")
    print("[serve/amg] " + svc.report().summary().replace("\n", "\n[serve/amg] "))
    # a bfloat16 x holds 8 bits, so its float64 true residual sits near 1e-2
    # whatever the tolerance (the reference's bf16 sessions: 8e-3 to 1.2e-2)
    bar = cfg.tol * 100
    if args.amg_backend == "torch" and cfg.dtype == "bfloat16":
        bar = max(bar, BF16_TRUE_RESIDUAL)
    if worst > bar:
        raise SystemExit(f"residual check failed: {worst:.2e}")
    return {**s, "worst_rel_residual": worst}


def parse_tenant_spec(spec: str, config, *, max_rhs: int,
                      coalesce_window: float):
    """``NAME[:MAX_INFLIGHT[:MAX_MATRIX_BYTES]]`` -> (name, TenantSpec)."""
    from ..serve import TenantSpec

    name, _, rest = spec.partition(":")
    if not name:
        raise SystemExit(f"--tenant {spec!r}: empty tenant name")
    parts = rest.split(":") if rest else []
    try:
        max_inflight = int(parts[0]) if parts and parts[0] else 32
        max_bytes = (int(parts[1]) if len(parts) > 1 and parts[1]
                     else None)
    except ValueError:
        raise SystemExit(f"--tenant {spec!r}: quotas must be integers "
                         f"(NAME[:MAX_INFLIGHT[:MAX_MATRIX_BYTES]])")
    return name, TenantSpec(config=config, max_inflight=max_inflight,
                            max_matrix_bytes=max_bytes, max_rhs=max_rhs,
                            coalesce_window=coalesce_window)


def run_listen(args):
    import asyncio

    from ..serve import AMGWireServer

    cfg = _amg_config(args)
    tenants = dict(
        parse_tenant_spec(spec, cfg, max_rhs=args.batch,
                          coalesce_window=args.coalesce_window)
        for spec in (args.tenant or ["default"]))
    host, _, port = args.listen.rpartition(":")
    server = AMGWireServer(tenants)

    async def _serve():
        h, p = await server.start(host or "127.0.0.1", int(port or 0))
        print(f"[serve/amg] AMGWire listening on {h}:{p} (backend="
              f"{args.amg_backend}, {cfg.dtype}, tenants: "
              + ", ".join(f"{n}[inflight<={t.max_inflight}]"
                          for n, t in sorted(tenants.items()))
              + ")", flush=True)
        try:
            await server.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await server.aclose()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", choices=("lm", "amg"), default="lm")
    ap.add_argument("--arch", help="LM architecture (required for --solver lm)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM depth (default: the arch's, or 4 with "
                         "--reduced)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="the prompts' seed (tokens, or the stub frontend's "
                         "embeddings for an embedding-input arch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    # amg knobs
    ap.add_argument("--amg-backend", choices=("host", "torch"),
                    default="torch",
                    help="AMG backend: torch (default; the card, or the CPU "
                         "with --device cpu) or host (numpy)")
    ap.add_argument("--dtype", choices=("float32", "float64", "bfloat16"),
                    default="float32", help="torch backend compute dtype")
    ap.add_argument("--n", type=int, default=8,
                    help="largest Laplacian grid size for --solver amg")
    ap.add_argument("--n-pods", type=int, default=1)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--tol", type=float, default=None,
                    help="convergence tolerance (default 1e-6 for a float32 "
                         "torch backend, else 1e-8)")
    ap.add_argument("--method", choices=("solve", "pcg"), default="pcg")
    ap.add_argument("--wire", action="store_true",
                    help="drive the AMG service purely through encoded "
                         "wire payloads (matrices registered by "
                         "fingerprint, requests JSON round-tripped)")
    ap.add_argument("--coalesce-window", type=float, default=0.0,
                    help="seconds the admission worker holds a group open "
                         "to coalesce same-matrix RHS across bursts "
                         "(0 = synchronous drain)")
    ap.add_argument("--listen", metavar="HOST:PORT",
                    help="run the AMGWire socket server instead of the "
                         "in-process harness (--solver amg only); PORT 0 "
                         "picks a free port")
    ap.add_argument("--tenant", action="append", metavar="SPEC",
                    help="tenant spec NAME[:MAX_INFLIGHT[:MAX_MATRIX_"
                         "BYTES]], repeatable (default: one 'default' "
                         "tenant); only with --listen")
    args = ap.parse_args(argv)
    if args.solver == "amg":
        if args.listen:
            return run_listen(args)
        return run_amg(args)
    if not args.arch:
        raise SystemExit("--solver lm requires --arch")
    return run_lm(args)


if __name__ == "__main__":
    main()
