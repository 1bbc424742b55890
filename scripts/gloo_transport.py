#!/usr/bin/env python3
"""Time gloo's collectives on CUDA tensors, the ranks sharing one card.

    python3 scripts/gloo_transport.py

On one card the fsdp ranks (``distributed/ctx.SeqShard``) talk over gloo,
which moves CUDA tensors through host memory. For 2 and 4 ranks, one
process a rank on card 0, this prints one JSON line each: the seconds
(host clock, after a warm-up) of a device-to-host and a host-to-device
copy of a 96M-element fp32 gradient through pinned memory; its
reduce-scatter by gloo's own ``reduce_scatter_tensor`` and by an
all-to-all of its blocks summed on the card (both staged through pinned
memory; ``SeqShard.reduce_scatter`` takes the all-to-all over gloo and
sums the blocks on the host); and the
all-gather of a 48M-element bf16 tensor's blocks by gloo's CUDA
``all_gather`` and staged through pinned memory. The last line is the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

NUMEL = 96_000_000


def timed(torch, dist, fn) -> float:
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def rank_main(rank: int, n: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=n)
    dev = torch.device("cuda", 0)
    g = torch.randn(NUMEL, device=dev)
    pin = torch.empty(NUMEL, pin_memory=True)
    parts = torch.empty(NUMEL)

    def rs_gloo():
        pin.copy_(g)
        out = torch.empty(NUMEL // n)
        dist.reduce_scatter_tensor(out, pin)
        return out.to(dev)

    def rs_all_to_all():
        pin.copy_(g)
        dist.all_to_all_single(parts, pin)
        return parts.to(dev).view(n, -1).sum(0)

    x = torch.randn(NUMEL // n // 2, device=dev).to(torch.bfloat16)
    xpin = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)

    def ag_staged():
        xpin.copy_(x)
        whole = torch.empty(x.numel() * n, dtype=x.dtype)
        dist.all_gather_into_tensor(whole, xpin)
        return whole.to(dev)

    line = {"ranks": n, "fp32_elements": NUMEL,
            "d2h_pinned_s": timed(torch, dist, lambda: pin.copy_(g)),
            "h2d_pinned_s": timed(torch, dist, lambda: g.copy_(pin)),
            "reduce_scatter_gloo_s": timed(torch, dist, rs_gloo),
            "reduce_scatter_all_to_all_s": timed(torch, dist, rs_all_to_all),
            "all_gather_cuda_bf16_s": timed(
                torch, dist, lambda: dist.all_gather(
                    [torch.empty_like(x) for _ in range(n)], x)),
            "all_gather_staged_bf16_s": timed(torch, dist, ag_staged)}
    if rank == 0:
        print(json.dumps(line), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    for n in (4, 2):
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(rank_main, args=(n, f"{tmp}/store"), nprocs=n)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
