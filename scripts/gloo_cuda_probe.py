"""Which collectives gloo takes on CUDA tensors: 8 gloo processes on
``cuda:0`` run each collective once, functional (``torch.distributed.
_functional_collectives``, what DTensor issues) and plain (``torch.
distributed``), each in its own 8 processes so that a crash stops only its
own; prints ``<op> ok`` from rank 0 and every op's exit codes (-11: a
segfault).  On the card::

    python3 scripts/gloo_cuda_probe.py
"""
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single", "c10d_allreduce", "c10d_allgather_base",
       "c10d_reduce_scatter_base", "c10d_alltoall_base")


def child(rank: int, op: str, init: str) -> None:
    import torch.distributed._functional_collectives as funcol
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=8)
    torch.cuda.set_device(0)
    x = torch.ones(8, 4, device="cuda")
    g = dist.group.WORLD
    if op == "all_reduce":
        y = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
    elif op == "all_gather_into_tensor":
        y = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, g))
    elif op == "reduce_scatter_tensor":
        y = funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, g))
    elif op == "all_to_all_single":
        y = funcol.wait_tensor(funcol.all_to_all_single(x, None, None, g))
    elif op == "c10d_allreduce":
        dist.all_reduce(x)
        y = x
    elif op == "c10d_allgather_base":
        y = torch.empty(64, 4, device="cuda")
        dist.all_gather_into_tensor(y, x)
    elif op == "c10d_reduce_scatter_base":
        y = torch.empty(1, 4, device="cuda")
        dist.reduce_scatter_tensor(y, x)
    else:
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
    torch.cuda.synchronize()
    if rank == 0:
        print(op, "ok", tuple(y.shape), float(y.sum()), flush=True)
    dist.destroy_process_group()


def main() -> None:
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    ctx = mp.get_context("spawn")
    for op in OPS:
        init = f"file://{tempfile.mkdtemp()}/rendezvous"
        procs = [ctx.Process(target=child, args=(r, op, init))
                 for r in range(8)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        for p in procs:
            if p.is_alive():
                p.kill()
        print(op, "exit codes", [p.exitcode for p in procs], flush=True)


if __name__ == "__main__":
    main()
