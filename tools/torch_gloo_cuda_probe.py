"""Which torch.distributed ops gloo takes on CUDA tensors, two processes on
one card: one world for bf16, then one for f32, each op once in a fixed
order.  Then the point-to-point pair and each uneven
``all_to_all_single`` (the whole tensor to one peer and nothing to the
others, the ring permute of
``paddle_tpu_torch.distributed.collective.ppermute``: on 2-D rows, on
1-D, as an async handle, and staged through host tensors) in a world of
its own, so that an op that aborts the processes is named.  A failed op can break the pair's
connection, so every op after it in that world fails as well, and an op
that aborts inside the native library ends the world ("no result").

Run on a machine with a card: ``python3 tools/torch_gloo_cuda_probe.py``;
prints the interpreter, torch and CUDA versions, the card, and one JSON
object of {dtype: {op: "ok" or the error's first line}}.
"""
import json
import queue
import socket
import sys
import time

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
    return res


#: the uneven all_to_all_single variants: (flatten to 1-D, async handle,
#: staged through host tensors)
UNEVEN = {"all_to_all_single_uneven": (False, False, False),
          "all_to_all_single_uneven_1d": (True, False, False),
          "all_to_all_single_uneven_async": (True, True, False),
          "all_to_all_single_uneven_staged": (True, True, True)}


def alone(rank, world, dev, dt, name):
    """``send_recv``, or one ring permute (rank r -> r + 1) as ``name`` of
    :data:`UNEVEN`."""
    res = {}
    if name == "send_recv":
        try:
            x = torch.ones((8, 4), device=dev, dtype=dt)
            if rank == 0:
                dist.send(x, 1)
            else:
                dist.recv(torch.empty_like(x), 0)
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # the backend's own words
            res[name] = "%s: %s" % (type(e).__name__,
                                    str(e).splitlines()[0][:200])
        return res
    flat, async_op, staged = UNEVEN[name]
    try:
        x = torch.full((8, 4), float(rank + 1), device=dev, dtype=dt)
        dst, src = (rank + 1) % world, (rank - 1) % world
        send = x.reshape(-1) if flat else x
        if staged:
            send = send.cpu()
        n = int(send.shape[0])
        out = torch.empty_like(send)
        work = dist.all_to_all_single(
            out, send, [n if j == src else 0 for j in range(world)],
            [n if j == dst else 0 for j in range(world)], async_op=async_op)
        if async_op:
            work.wait()
        out = out.to(dev)
        torch.cuda.synchronize()
        if not bool((out == float(src + 1)).all()):
            raise AssertionError("received %r" % (out.flatten()[:4],))
        res[name] = "ok"
    except Exception as e:  # the backend's own words
        res[name] = "%s: %s" % (type(e).__name__,
                                str(e).splitlines()[0][:200])
    return res


def worker(rank, world, port, dtype, out, name=None):
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            init_method="tcp://127.0.0.1:%d" % port)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dt = getattr(torch, dtype)
    res = (ops(rank, world, dev, dt) if name is None
           else alone(rank, world, dev, dt, name))
    if rank == 0:
        out.put(res)
    dist.destroy_process_group()


def world_of_two(ctx, dtype, name=None, timeout=60):
    """Run ``ops`` (or one uneven variant) in a fresh world of two."""
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=worker, args=(r, 2, port, dtype, q, name))
             for r in range(2)]
    for p in procs:
        p.start()
    res, t0 = None, time.monotonic()
    while res is None and time.monotonic() - t0 < timeout:
        try:
            res = q.get(timeout=1)
        except queue.Empty:
            if not any(p.is_alive() for p in procs):
                break
    if res is None:
        res = {name or "ops": "no result (exit codes %s)"
               % ([p.exitcode for p in procs],)}
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(5)
    return res


def main():
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    ctx = mp.get_context("spawn")
    report = {}
    for dtype in ("bfloat16", "float32"):
        report[dtype] = world_of_two(ctx, dtype)
        for name in ("send_recv",) + tuple(UNEVEN):
            report[dtype].update(world_of_two(ctx, dtype, name))
    print(json.dumps(report, indent=1), flush=True)


if __name__ == "__main__":
    main()
