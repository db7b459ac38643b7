"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): trace every
(architecture × input shape × mesh) cell on a fake process group and
extract the roofline's inputs.

The reference lowers and compiles each cell with ``jax.jit`` on 256 or 512
placeholder devices.  Here the cell's parameters, optimizer state and
inputs are DTensors placed on a :class:`DeviceMesh` over a fake group
(:func:`~repro_torch.launch.mesh.make_production_mesh`), all fake tensors
(``FakeTensorMode``: shapes, no memory), and the step runs once, as rank 0
sees it.  While it runs:

* :class:`TraceCounter` counts rank 0's FLOPs and bytes from the *local*
  shapes of the ops the DTensors run (a ``FlopCounterMode`` around DTensor
  ops would count the global shapes) and the peak of live fake storage;
* :class:`~repro_torch.launch.roofline.CollectiveLog` records every
  collective with its group's ranks.

A production-form trace gives the memory and the proof that the cell
traces; two probes at 1 and 2 pattern groups give the counts, extrapolated
linearly to full depth, as the reference does.  The AMG cell
(:func:`run_amg_cell`) runs for real: one logged halo exchange per
strategy on the card's stacked ranks.

CLI: ``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
train_4k [--multi-pod] [--device cpu]`` or ``--amg``; results
are appended to ``--out`` (``dryrun_results.json``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import weakref

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import cells, get_arch, get_shape
from ..core.nap_collectives import distribute, implicit_replication, replicate
from ..models.act_sharding import activation_sharding, placements_of
from ..models.model import LM, init_params
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.sharding import cache_specs, named, param_specs
from ..train.train_step import TrainOptions, build_train_step, shard_state
from .mesh import dp_axes_of, make_production_mesh, mesh_sizes, pod_size_of
from .roofline import CollectiveLog, HBM_BW, collective_totals, roofline_terms
from .specs import analytic_memory_floor, model_flops

# microbatches a train_4k step per arch (keep a device's live tokens sane)
TRAIN_MICROBATCHES = {
    "mixtral-8x22b": 8, "qwen3-moe-235b-a22b": 16, "starcoder2-7b": 8,
    "recurrentgemma-9b": 16, "phi-3-vision-4.2b": 4, "musicgen-medium": 4,
    "qwen3-1.7b": 4, "qwen2-0.5b": 4, "qwen1.5-0.5b": 4, "xlstm-125m": 2,
}

# production cell options of the reference's hillclimb (plain data)
PROD_CELL_OPTS = {
    ("qwen3-moe-235b-a22b", "train_4k"): {
        "extra_opts": {"sp_residual": True, "loss_chunk": 256,
                       "bf16_moments": True}},
    ("qwen3-moe-235b-a22b", "prefill_32k"): {
        "extra_opts": {"sp_residual": True}},
    ("mixtral-8x22b", "train_4k"): {
        "extra_opts": {"sp_residual": True, "loss_chunk": 256,
                       "bf16_moments": True}},
    ("mixtral-8x22b", "prefill_32k"): {
        "extra_opts": {"sp_residual": True}},
    ("qwen2-0.5b", "train_4k"): {"sp_attn": True,
                                 "extra_opts": {"loss_chunk": 256}},
    ("musicgen-medium", "train_4k"): {"sp_attn": True},
    ("starcoder2-7b", "train_4k"): {"sp_attn": True},
}


def _dp_for(shape, mesh):
    if shape.global_batch == 1:
        return ()                      # long_500k: nothing to shard on batch
    return dp_axes_of(mesh)


# --------------------------------------------------------------------------
# Counting a trace: rank 0's FLOPs, bytes and live storage
# --------------------------------------------------------------------------

class _Propagation:
    """Marks DTensor's sharding propagation, which runs ops on the global
    shapes to infer the outputs' metadata: those ops are not rank 0's."""

    def __init__(self):
        self.depth = 0
        self._saved = []

    def __enter__(self):
        prop = DTensor._op_dispatcher.sharding_propagator
        for name in ("propagate", "_propagate_tensor_meta_non_cached"):
            fn = getattr(prop, name, None)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, **k):
                self.depth += 1
                try:
                    return _fn(*a, **k)
                finally:
                    self.depth -= 1

            self._saved.append((prop, name, prop.__dict__.get(name)))
            setattr(prop, name, wrapped)
        return self

    def __exit__(self, *exc):
        for prop, name, old in reversed(self._saved):
            if old is None:
                delattr(prop, name)
            else:
                setattr(prop, name, old)
        self._saved.clear()


class TraceCounter(TorchDispatchMode):
    """Rank 0's work in a DTensor trace: ``flops`` (matrix products etc.,
    by :data:`torch.utils.flop_counter.flop_registry` on the local shapes),
    ``bytes`` (every non-view op's inputs read once and outputs written
    once: the unfused traffic, the counterpart of XLA's "bytes accessed")
    and ``peak`` (the most bytes of fake storage alive at once, tracked
    per storage with weak references, with :meth:`track`'s tensors alive
    from the start).  A DTensor op is handed back to DTensor (the mode
    returns ``NotImplemented``), whose local ops then come through here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, list] = {}     # storage key -> [count, nbytes]
        self._prop = _Propagation()

    def __enter__(self):
        self._prop.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._prop.__exit__(*exc)

    # -- live storage ------------------------------------------------------
    def _release(self, key):
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live -= ent[1]
            del self._refs[key]

    def track(self, t) -> None:
        """Count ``t``'s storage as alive while ``t`` lives (a DTensor:
        its local tensor)."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor):
            return
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        ent = self._refs.get(key)
        if ent is None:
            ent = self._refs[key] = [0, st.nbytes()]
            self.live += ent[1]
            self.peak = max(self.peak, self.live)
        ent[0] += 1
        weakref.finalize(t, self._release, key)

    # -- the ops -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._prop.depth:
            return out
        packet = func.overloadpacket
        fl = self._flop_registry.get(packet)
        if fl is not None:
            self.flops += fl(*args, **kwargs, out_val=out)
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not func.is_view and func.namespace == "aten":
            ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self.track(t)
        return out


def _settle(out):
    """The step's outputs with their pending sums taken (a Partial
    placement made Replicate), as reading them would."""
    return torch.utils._pytree.tree_map(
        lambda t: t.redistribute(t.device_mesh, [
            replicate() if p.is_partial() else p for p in t.placements])
        if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements)
        else t, out)


def _tree_tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


# --------------------------------------------------------------------------
# Building a cell
# --------------------------------------------------------------------------

def _distribute_tree(tree, mesh, specs):
    """``tree`` (dicts / tuples of tensors) placed by the same tree of
    specs."""
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, mesh, specs[k])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_distribute_tree(v, mesh, s)
                          for v, s in zip(tree, specs))
    return distribute(tree, mesh, placements_of(mesh, specs))


def build_cell(arch_name: str, shape_name: str, mesh, *, zero1: bool = True,
               microbatches: int | None = None, use_kernel: bool = False,
               extra_opts: dict | None = None, cfg_override=None,
               unroll: bool = False, sp_attn: bool = False):
    """Returns ``(trace, meta)`` for one cell: ``trace(counter=None,
    log=None)`` runs the cell's step once on fake DTensors (entering its
    own ``FakeTensorMode``, then ``counter`` and ``log`` when given, and the
    activation-sharding context).  ``sp_attn``: sequence-parallel
    attention.  ``unroll`` is the reference's and does nothing here."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg_override if cfg_override is not None else get_arch(arch_name)
    shape = get_shape(shape_name)
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        raise ValueError("cell is skipped: full attention at 500k")
    dp = _dp_for(shape, mesh)
    dpa = dp if dp else None
    sizes = mesh_sizes(mesh)
    ctx_kw = {}
    extra_opts = dict(extra_opts or {})
    sp_residual = extra_opts.pop("sp_residual", False) and \
        shape.kind in ("train", "prefill")
    if sp_residual:
        ctx_kw.update(residual_spec=(dpa, "model", None))
    if sp_attn:
        ctx_kw.update(qkv_spec=(dpa, "model", None, None),
                      kv_spec=(dpa, None, None, None),
                      out_spec=(dpa, None, None))
    model_size = sizes["model"]
    ep_axis, ep_size = None, 1
    if cfg.is_moe and cfg.n_experts % sizes["data"] == 0 and not \
            extra_opts.pop("no_moe_ep", False):
        ep_axis, ep_size = "data", sizes["data"]
        ctx_kw.update(moe_ep=dict(
            mesh=mesh, dp_axes=dp, ep_axes=("data",), tp_axis="model",
            nap=False, seq_axis="model" if sp_residual else None))
    elif cfg.is_moe:
        # TP-MoE (mixtral): the dispatch buffer's capacity dim over dp
        ctx_kw.update(moe_buf_spec=(None, dpa, "model"))
    if shape.kind == "decode":
        ctx_kw.update(scores_spec=(dpa, None, None, None, None),
                      q5_spec=(dpa, None, None, None, "model"))
    n_dev = mesh.mesh.numel()
    meta = {"arch": arch_name, "shape": shape_name,
            "mesh": "x".join(str(s) for s in mesh.mesh.shape),
            "n_devices": int(n_dev), "model_flops": model_flops(cfg, shape)}
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    dev = torch.device(mesh.device_type)
    dtype = torch.bfloat16
    B, S = shape.global_batch, shape.seq_len

    def tokens(b, s):
        if cfg.embed_input:
            return torch.zeros((b, s), dtype=torch.int32, device=dev)
        return torch.zeros((b, s, cfg.d_model), dtype=dtype, device=dev)

    with mode:
        model = LM(cfg, init_params(cfg, torch.Generator(device=dev), dtype,
                                    dev))
        params_shape = dict(model.named_parameters())
        model.requires_grad_(shape.kind == "train")
        state: dict = {}
        if shape.kind == "train":
            mb = microbatches if microbatches is not None else \
                TRAIN_MICROBATCHES.get(arch_name, 1)
            if len(dp) == 2:
                mb = max(1, mb // 2)     # twice the dp shards in multi-pod
            bf16_mom = extra_opts.pop("bf16_moments", False)
            opts = TrainOptions(remat=True, microbatches=mb,
                                use_kernel=use_kernel, dp_axes=dp,
                                unroll=unroll, zero2=zero1, **extra_opts)
            step, (p_pl, o_pl, b_pl) = build_train_step(
                cfg, AdamWConfig(), opts, mesh=mesh, params_shape=params_shape,
                ep_axis=ep_axis, ep_size=ep_size)
            opt = init_opt_state(params_shape, torch.bfloat16 if bf16_mom
                                 else torch.float32)
            opt["count"] = 0     # a host int: read by AdamW
            opt = shard_state(model, opt, mesh, p_pl, o_pl)
            batch = {"inputs": distribute(tokens(B, S), mesh, b_pl["inputs"]),
                     "targets": distribute(
                         torch.zeros((B, S), dtype=torch.int32, device=dev),
                         mesh, b_pl["targets"])}
            state.update(model=model, opt=opt, batch=batch)
            meta["microbatches"] = mb

            def run():
                return step(state["model"], state["opt"], state["batch"])
        else:
            shard_state(model, None, mesh, named(mesh, param_specs(
                cfg, params_shape, "model", model_size, ep_axis=ep_axis,
                ep_size=ep_size)))
        if shape.kind == "prefill":
            x = tokens(B, S)
            inp = distribute(x, mesh, placements_of(
                mesh, (dpa,) + (None,) * (x.ndim - 1)))
            state.update(model=model, inputs=inp)

            def run():
                with torch.no_grad():
                    logits, caches = state["model"](
                        state["inputs"], return_cache=True,
                        use_kernel=use_kernel)
                return logits[:, -1], caches
        elif shape.kind == "decode":
            from ..models.model import init_cache
            x = tokens(B, 1)
            inp = distribute(x, mesh, placements_of(
                mesh, (dpa,) + (None,) * (x.ndim - 1)))
            g_spec, e_spec = cache_specs(cfg, dpa, "model")
            cache = init_cache(cfg, B, S, dtype, device=dev)
            cache = (_distribute_tree(cache[0], mesh, g_spec),
                     _distribute_tree(cache[1], mesh, e_spec))
            state.update(model=model, inputs=inp, cache=cache)

            def run():
                with torch.no_grad():
                    return state["model"].decode_step(
                        state["inputs"], state["cache"], S - 1)

    def trace(counter: TraceCounter | None = None,
              log: CollectiveLog | None = None):
        with contextlib.ExitStack() as stack:
            stack.enter_context(mode)
            if counter is not None:
                stack.enter_context(counter)
                for t in _tree_tensors(state) + _tree_tensors(
                        dict(state["model"].named_parameters())):
                    counter.track(t)
            if log is not None:
                stack.enter_context(log)
            stack.enter_context(implicit_replication())
            stack.enter_context(activation_sharding(**ctx_kw))
            return _settle(run())

    meta["_state"] = state
    return trace, meta


def _compile_cell(arch_name, shape_name, mesh, pod_size, **kw):
    """Build and trace one cell: its FLOPs and bytes a device, its peak
    live bytes a device, its collectives, and the seconds each took."""
    t0 = time.perf_counter()
    trace, meta = build_cell(arch_name, shape_name, mesh, **kw)
    t1 = time.perf_counter()
    counter, log = TraceCounter(), CollectiveLog()
    trace(counter=counter, log=log)
    t2 = time.perf_counter()
    meta.pop("_state", None)
    coll = collective_totals(log.entries, pod_size=pod_size,
                             n_devices=int(mesh.mesh.numel()))
    meta.update({"build_s": round(t1 - t0, 2), "trace_s": round(t2 - t1, 2)})
    return {"flops": counter.flops, "bytes": counter.bytes,
            "peak_bytes": counter.peak, "coll": coll, "log": log.entries,
            "meta": meta}


def run_cell(arch_name, shape_name, multi_pod=False, verbose=True,
             zero1=True, microbatches=None, mesh=None, production=True,
             **kw):
    """One cell = a production-form trace (the proof it traces, and its
    peak memory) + two shallow probes (1 and 2 pattern groups, one
    microbatch) whose counts extrapolate linearly to full depth, as the
    reference's scheme has it (the CPU tests hold the extrapolation to a
    full-depth trace).  ``production=False`` skips the production trace:
    the probes then run the production microbatches, and the peak memory
    too is extrapolated from them (``peak_from``): an estimate, which
    misses a term that overtakes the probes' peak only past their depth
    (the CPU test shows one: recurrentgemma's prefill caches)."""
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device_type=kw.pop("device_type", "cuda"))
    kw.pop("device_type", None)
    pod_size = pod_size_of(mesh)
    cfg = kw.pop("cfg_override", None) or get_arch(arch_name)
    plen = len(cfg.pattern)
    G, extra = cfg.n_layers // plen, cfg.n_layers % plen
    shape = get_shape(shape_name)
    prod = None
    if production:
        prod = _compile_cell(arch_name, shape_name, mesh, pod_size,
                             zero1=zero1, microbatches=microbatches,
                             cfg_override=cfg, **kw)

    probes = []
    for g in (1, 2):
        sub = dataclasses.replace(cfg, n_layers=g * plen + extra)
        probes.append(_compile_cell(
            arch_name, shape_name, mesh, pod_size, cfg_override=sub,
            zero1=zero1, microbatches=1 if production else microbatches,
            **kw))

    def xq(f):
        q1, q2 = f(probes[0]), f(probes[1])
        return q1 + (G - 1) * (q2 - q1)

    if prod is not None:
        meta = prod["meta"]
        meta["peak_bytes_per_dev"] = prod["peak_bytes"]
        meta["peak_from"] = "production trace"
    else:
        meta = dict(probes[0]["meta"], model_flops=model_flops(cfg, shape),
                    trace_s=sum(p["meta"]["trace_s"] for p in probes))
        meta["peak_bytes_per_dev"] = xq(lambda r: r["peak_bytes"])
        meta["peak_from"] = "probes"
    flops = xq(lambda r: r["flops"])
    hbytes = xq(lambda r: r["bytes"])
    coll = {"total_bytes": xq(lambda r: r["coll"]["total_bytes"]),
            "cross_slow_bytes": xq(lambda r: r["coll"]["cross_slow_bytes"])}
    ncoll = xq(lambda r: r["coll"]["n_collectives"])
    terms = roofline_terms(flops, hbytes, coll, meta["n_devices"],
                           meta["model_flops"])
    floor = analytic_memory_floor(cfg, shape, meta["n_devices"])
    meta.update({
        "memory_floor_bytes_per_dev": floor,
        "memory_floor_s": floor / HBM_BW,
        "flops_per_dev": flops, "bytes_per_dev": hbytes,
        "coll_bytes_per_dev": coll["total_bytes"],
        "cross_pod_bytes_per_dev": coll["cross_slow_bytes"],
        "n_collectives": ncoll,
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "cross_pod_s": terms.cross_pod_s,
        "dominant": terms.dominant,
        "useful_flops_fraction": terms.useful_flops_fraction,
        "roofline_fraction": terms.roofline_fraction,
        "probe_trace_s": [p["meta"]["trace_s"] for p in probes],
        "n_layers": cfg.n_layers,
    })
    if verbose:
        print(f"[dryrun] {arch_name} × {shape_name} × {meta['mesh']}: "
              f"trace {meta['trace_s']}s, peak/dev "
              f"{meta['peak_bytes_per_dev'] / 2**30:.2f} GiB, "
              f"dominant={meta['dominant']}, "
              f"roofline={meta['roofline_fraction']:.3f}", flush=True)
    return meta


def run_amg_cell(multi_pod=True, n=24, strategies=("standard", "nap2", "nap3"),
                 verbose=True, device="cuda", lanes=256, dtype=torch.float64):
    """The paper's own workload on the production mesh: the distributed
    SpMV's halo exchange for a 3-D Laplacian, one logged apply per strategy
    on ``n_pods x lanes`` stacked ranks on ``device`` (for real, not
    traced).  Reports a rank's collective bytes and pod-crossing bytes and
    the number of collectives from the apply's log; each strategy's halo
    is held bit-equal to ``x[need]``, its log to the plan's signature and
    its SpMV to the host's (``spmv_max_err``)."""
    from ..amg.dist_spmv import build_dist_operator
    from ..amg.problems import laplace_3d
    from ..amg.dist import rect_vector_graph
    from ..core.nap_collectives import SizedLog, halo_exchange, halo_signature
    from ..device import resolve_device

    dev = resolve_device(device)
    n_pods = 2 if multi_pod else 1
    D = n_pods * lanes
    A = laplace_3d(n)
    rng = np.random.default_rng(0)
    xg = rng.standard_normal(A.nrows)
    out = []
    for strat in strategies:
        t0 = time.perf_counter()
        np_dt = torch.empty((), dtype=dtype).numpy().dtype
        op = build_dist_operator(A, n_pods, lanes, strat, dtype=np_dt)
        arrs = op.to_device(dev, dtype)
        x = torch.as_tensor(op.scatter_x(xg), device=dev)
        xg_t = x.new_tensor(xg).cpu().numpy()     # x as the ranks hold it
        log = SizedLog(D)
        y = op.apply(arrs, x, use_kernel=dev.type == "cuda", log=log)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        meta = {"arch": f"amg_spmv_{strat}", "shape": f"laplace3d_n{n}",
                "mesh": f"{n_pods}x{lanes}", "n_devices": D,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "apply_s": round(t1 - t0, 3),
                "coll_bytes_per_dev": sum(r[1] for r in log.records),
                "cross_pod_bytes_per_dev": sum(r[1] for r in log.records
                                               if r[2]),
                "n_collectives": len(log), "log": list(log)}
        psel = None if op.plan.pool_sel is None else arrs["psel"]
        halo = halo_exchange(x, op.plan, arrs["send"], arrs["recv"],
                             psel).cpu().numpy()
        graph = rect_vector_graph(A, op.row_part, op.col_part)
        for d in range(D):
            need = np.sort(graph.need[d])
            if not np.array_equal(halo[d, :need.size], xg_t[need]):
                raise AssertionError(f"{strat}: rank {d}'s halo is not "
                                     f"x[need]")
        if tuple(log) != halo_signature(op.plan):
            raise AssertionError(f"{strat}: log {list(log)} against "
                                 f"{halo_signature(op.plan)}")
        want = np.add.reduceat(A.data * xg_t[A.indices], A.indptr[:-1])
        got = op.gather_y(y.cpu().numpy())
        meta["spmv_max_err"] = float(np.abs(got - want).max())
        meta["halo_bit_equal"] = True
        out.append(meta)
        if verbose:
            print(f"[dryrun] AMG spmv {strat} × {meta['mesh']}: "
                  f"coll={meta['coll_bytes_per_dev']:.3e} B "
                  f"xpod={meta['cross_pod_bytes_per_dev']:.3e} B "
                  f"n={meta['n_collectives']}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cpu: no card needed)")
    ap.add_argument("--amg", action="store_true",
                    help="run the AMG distributed-SpMV cell instead")
    args = ap.parse_args(argv)

    if args.amg:
        results = []
        if os.path.exists(args.out):
            results = json.load(open(args.out))
        results = [r for r in results
                   if not str(r.get("arch", "")).startswith("amg_spmv")]
        results.extend(run_amg_cell(multi_pod=True, device=args.device))
        json.dump(results, open(args.out, "w"), indent=1)
        print(f"[dryrun] wrote {args.out}")
        return

    results = []
    if os.path.exists(args.out):
        results = json.load(open(args.out))
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    todo = []
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    if args.all:
        for a, s, skip in cells():
            if skip:
                results = [r for r in results if not (
                    r["arch"] == a.name and r["shape"] == s.name)]
                results.append({"arch": a.name, "shape": s.name,
                                "mesh": "all", "skipped": skip})
                continue
            todo += [(a.name, s.name, mp) for mp in meshes]
    else:
        todo += [(args.arch, args.shape, mp) for mp in meshes]

    for a, s, mp in todo:
        mesh_tag = "2x16x16" if mp else "16x16"
        if (a, s, mesh_tag) in done:
            print(f"[dryrun] skip cached {a} × {s} × {mesh_tag}")
            continue
        try:
            kw = {k: (dict(v) if isinstance(v, dict) else v)
                  for k, v in PROD_CELL_OPTS.get((a, s), {}).items()}
            meta = run_cell(a, s, multi_pod=mp, zero1=not args.no_zero1,
                            device_type=args.device, **kw)
        except Exception as e:   # one failed cell is recorded, the rest run
            meta = {"arch": a, "shape": s, "mesh": mesh_tag,
                    "error": f"{type(e).__name__}: {e}"}
            print(f"[dryrun] FAIL {a} × {s} × {mesh_tag}: {meta['error']}")
        results.append(meta)
        json.dump(results, open(args.out, "w"), indent=1, default=str)
    print(f"[dryrun] wrote {args.out} ({len(results)} entries)")


if __name__ == "__main__":
    main()


# --------------------------------------------------------------------------
# One sharded train step, real or fake: the dry-run's trace held to a run
# --------------------------------------------------------------------------

def sharded_step(mesh, cfg, inputs: np.ndarray, targets: np.ndarray,
                 opts: TrainOptions, seed: int = 0, dtype=torch.float32,
                 fake: bool = False) -> dict:
    """One AdamW step of a fresh ``init_lm(cfg, seed)`` on ``mesh`` (its
    parameters placed by :func:`~repro_torch.train.sharding.param_specs`,
    the moments by ZeRO's specs under ``opts.zero2``, the batch over the dp
    axes: :func:`~repro_torch.train.train_step.build_train_step`'s
    placements), with its collectives logged.  ``fake``: on fake tensors
    (the mesh over a fake group); else for real on this rank's share.
    Returns ``{"log"}`` and, for a real run, ``"loss"``, ``"grad_norm"``
    and ``"params"``, ``"m"``, ``"v"``: every parameter and AdamW moment
    after the step, gathered whole (numpy)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.model import init_lm

    dev = torch.device(mesh.device_type)
    ctx = FakeTensorMode(allow_non_fake_inputs=True) if fake else \
        contextlib.nullcontext()
    with ctx:
        model = init_lm(cfg, seed=seed, dtype=dtype, device=dev,
                        trainable=True) if not fake else \
            LM(cfg, init_params(cfg, torch.Generator(device=dev), dtype,
                                dev)).requires_grad_(True)
        shapes = dict(model.named_parameters())
        step, (p_pl, o_pl, b_pl) = build_train_step(
            cfg, AdamWConfig(), opts, mesh=mesh, params_shape=shapes)
        opt = init_opt_state(shapes)
        opt["count"] = 0
        opt = shard_state(model, opt, mesh, p_pl, o_pl)
        batch = {k: distribute(torch.as_tensor(v, device=dev), mesh, b_pl[k])
                 for k, v in (("inputs", inputs), ("targets", targets))}
        log = CollectiveLog()
        with log, implicit_replication():
            _, opt, om = step(model, opt, batch)
            loss = _settle(om["loss"])
        out = {"log": [e.key() for e in log.entries]}
        if not fake:
            out["loss"] = float(loss.full_tensor() if isinstance(loss, DTensor)
                                else loss)
            out["grad_norm"] = float(om["grad_norm"])

            def whole(t):
                return t.full_tensor().detach().cpu().numpy()

            out["params"] = {n: whole(p) for n, p in model.named_parameters()}
            out["m"] = {n: whole(t) for n, t in opt["m"].items()}
            out["v"] = {n: whole(t) for n, t in opt["v"].items()}
    return out


def sharded_step_rank(ranks, cfg, inputs, targets, opts: TrainOptions,
                      device: str = "cpu", seed: int = 0) -> dict | None:
    """:func:`sharded_step` on one real rank of a (2, 2, 2) (pod, data,
    model) mesh over the spawned group of 8 (``repro_torch.launch.ranks.
    spawn(sharded_step_rank, 2, 4, ...)``); rank 0 returns its log, the
    loss and the gathered parameters, the others None."""
    from .mesh import make_mesh
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type=device,
                     fake=False)
    out = sharded_step(mesh, cfg, inputs, targets, opts, seed=seed)
    return out if ranks.rank == 0 else None
