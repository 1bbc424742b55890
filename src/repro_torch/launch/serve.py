"""Serving launcher: batched prefill+decode over the ServingEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --device cpu --requests 8 --prompt-len 12 --max-new 8

Port of ``repro/launch/serve.py``: the same flags, the same prompts
(numpy's ``default_rng(0)``), the port's own init from seed 0, plus
``--device`` (default ``cuda``, which raises where there is no CUDA
device; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch, get_smoke
from repro_torch.models.api import build_model
from repro_torch.serving import Request, ServingEngine


def main(argv=None, params=None):
    """Serve ``--requests`` random prompts; returns rid -> tokens.
    ``params`` replaces the init's weights (e.g. converted ones)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    model = build_model(cfg)
    if params is None:
        params = model.init(seed=0, device=args.device)
    engine = ServingEngine(model, params, max_len=args.max_len,
                           batch_size=args.batch_size, device=args.device)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(
                    3, cfg.vocab_size, size=(args.prompt_len,)
                ).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    out = engine.serve(reqs)
    dt = time.time() - t0
    n_tok = sum(len(v) for v in out.values())
    print(f"[serve] {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s on {engine.device})")
    for rid in sorted(out):
        print(f"  req {rid}: {out[rid][:16].tolist()}")
    return out


if __name__ == "__main__":
    main()
