"""Which torch.distributed ops gloo takes on CUDA tensors, two processes on
one card: one world for bf16, then one for f32, each op once in a fixed
order, the point-to-point pair last.  A failed op can break the pair's
connection, so every op after it in that world fails as well, and an op
that aborts inside the native library ends the world ("no result").

Run on a machine with a card: ``python3 tools/torch_gloo_cuda_probe.py``;
prints the interpreter, torch and CUDA versions, the card, and one JSON
object of {dtype: {op: "ok" or the error's first line}}.
"""
import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ops(rank, world, dev, dt):
    res = {}

    def run(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # the backend's own words
            res[name] = "%s: %s" % (type(e).__name__,
                                    str(e).splitlines()[0][:200])

    x = torch.full((8, 4), float(rank + 1), device=dev, dtype=dt)

    def empty(rows):
        return torch.empty((rows, 4), device=dev, dtype=dt)

    def send_recv():
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(torch.empty_like(x), 0)

    run("all_reduce_sum", lambda: dist.all_reduce(x.clone()))
    run("all_reduce_max", lambda: dist.all_reduce(
        x.clone(), op=dist.ReduceOp.MAX))
    run("all_reduce_prod", lambda: dist.all_reduce(
        x.clone(), op=dist.ReduceOp.PRODUCT))
    run("all_gather_list", lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(world)], x))
    run("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        empty(8 * world), x))
    run("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        empty(8 // world), x))
    run("broadcast", lambda: dist.broadcast(x.clone(), src=0))
    run("reduce", lambda: dist.reduce(x.clone(), dst=0))
    run("scatter", lambda: dist.scatter(
        torch.empty_like(x),
        [x.clone() for _ in range(world)] if rank == 0 else None, src=0))
    run("all_to_all_single", lambda: dist.all_to_all_single(
        torch.empty_like(x), x))
    run("all_to_all_list", lambda: dist.all_to_all(
        [torch.empty_like(c) for c in x.chunk(world)],
        list(x.chunk(world))))
    run("barrier", lambda: dist.barrier())
    run("send_recv", send_recv)
    return res


def worker(rank, world, port, dtype, out):
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            init_method="tcp://127.0.0.1:%d" % port)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = ops(rank, world, dev, getattr(torch, dtype))
    if rank == 0:
        out.put(res)
    dist.destroy_process_group()


def main():
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    ctx = mp.get_context("spawn")
    report = {}
    for dtype in ("bfloat16", "float32"):
        q = ctx.Queue()
        port = free_port()
        procs = [ctx.Process(target=worker, args=(r, 2, port, dtype, q))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            report[dtype] = q.get(timeout=180)
        except Exception as e:
            report[dtype] = "no result: %r" % (e,)
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
