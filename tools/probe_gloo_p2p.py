"""Whether gloo's point-to-point transfers take CUDA tensors as they are:
two ranks on ``cuda:0`` exchange an fp32 and a bf16 tensor unstaged,
through ``dist.send``/``dist.recv`` (``send``) or one
``dist.batch_isend_irecv`` batch (``batch``), and each rank reports
whether it received the other's values exactly. A rank that crashes in
the transport shows as a nonzero exit code. This is why
``apex_tpu_torch.utils.collectives.exchange`` stages CUDA tensors
through host buffers under gloo.

    python tools/probe_gloo_p2p.py send
    python tools/probe_gloo_p2p.py batch

Prints one JSON object: each rank's result by dtype and the ranks' exit
codes. Needs a CUDA card.
"""

import json
import multiprocessing as mp
import os
import sys
import tempfile
import time


def worker(rank, world, init, q, how):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = {}
    other = 1 - rank
    for dt in (torch.float32, torch.bfloat16):
        x = torch.arange(8, dtype=dt, device=dev) + 10 * rank
        y = torch.full((8,), -1, dtype=dt, device=dev)
        try:
            t = time.perf_counter()
            if how == "send":
                if rank == 0:
                    dist.send(x, other)
                    dist.recv(y, other)
                else:
                    dist.recv(y, other)
                    dist.send(x, other)
            else:
                for w in dist.batch_isend_irecv(
                        [dist.P2POp(dist.isend, x, other),
                         dist.P2POp(dist.irecv, y, other)]):
                    w.wait()
            torch.cuda.synchronize()
            want = torch.arange(8, dtype=dt, device=dev) + 10 * other
            res[str(dt)] = dict(ok=bool(torch.equal(y, want)),
                                got=y.float().cpu().tolist(),
                                ms=(time.perf_counter() - t) * 1e3)
        except Exception as e:
            res[str(dt)] = dict(ok=False, err=repr(e)[:300])
    q.put((rank, res))
    dist.destroy_process_group()


def main():
    how = sys.argv[1] if len(sys.argv) > 1 else "batch"
    if how not in ("send", "batch"):
        sys.exit("usage: probe_gloo_p2p.py send|batch")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = os.path.join(tempfile.mkdtemp(), "rendezvous")
    procs = [ctx.Process(target=worker, args=(r, 2, init, q, how))
             for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            r, res = q.get(timeout=60)
            out[r] = res
    except Exception as e:
        out["error"] = repr(e)
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
    out["exitcodes"] = [p.exitcode for p in procs]
    print(json.dumps({how: out}))


if __name__ == "__main__":
    main()
