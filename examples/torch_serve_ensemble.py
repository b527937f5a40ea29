"""Ensemble serving with the PyTorch/CUDA port, the counterpart of
``examples/serve_ensemble.py``: a mixed-shape stream of simulation
requests drained through the batched fused-stencil engine —
shape-bucketed batching, one batched kernel launch per bucket and step
(B members in one launch: B5 on the card), and StragglerMonitor
flagging of slow batches (here injected).

Run:  PYTHONPATH=src python examples/torch_serve_ensemble.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.ft.supervisor import StragglerMonitor
from repro_torch.kernels import emit
from repro_torch.launch.serve_sim import SimServer, demo_queue


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--slow-batch", type=int, default=None,
                    help="inject a sleep into this batch index so the "
                         "straggler monitor fires (default: last batch)")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # Two interleaved request shapes -> two buckets; FIFO head-of-line
    # picks whichever bucket the oldest waiting request belongs to.
    queue = demo_queue([(16, 32), (12, 24)], args.steps, args.requests,
                       seed=1, device=device)
    n_batches_est = -(-args.requests // args.max_batch)
    slow = (args.slow_batch if args.slow_batch is not None
            else n_batches_est - 1)

    def inject(index, reqs):
        if index == slow:
            time.sleep(0.5)  # contended-member stand-in

    server = SimServer(
        strategy="swc",
        max_batch=args.max_batch,
        straggler=StragglerMonitor(factor=1.5, window=20),
        batch_hook=inject,
        device=device,
    )
    emit.reset_launch_counts()
    t0 = time.time()
    results = server.serve(queue)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    assert len(results) == args.requests

    print(f"{'batch':>5} {'bucket':>14} {'B':>3} {'seconds':>9} flag")
    for rep in server.reports:
        shape = "x".join(map(str, rep.key[0]))
        print(f"{rep.index:5d} {shape:>14} {rep.batch:3d} "
              f"{rep.seconds:9.4f} {'STRAGGLER' if rep.straggler else ''}")
    members = sum(r.batch for r in server.reports)
    print(
        f"\nserved {args.requests} members in {len(server.reports)} "
        f"batches / {server.op_builds} op builds, {wall:.2f}s "
        f"({members * args.steps / wall:.0f} member-steps/s on {device})"
    )
    flagged = [r.index for r in server.reports if r.straggler]
    print(f"straggler batches: {flagged or 'none'} "
          f"(monitor history {len(server.straggler._times)} batches)")
    print(f"fused-stencil launches: {emit.fused_stencil_swc.launches} "
          f"{dict(emit.fused_stencil_swc.launches_by_kernel)}")
    for rid, out in sorted(results.items())[:3]:
        print(f"  req {rid}: final field mean {float(out.mean()):+.3e}")
    print("serve_ensemble OK")


if __name__ == "__main__":
    main()
