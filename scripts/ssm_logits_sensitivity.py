#!/usr/bin/env python3
"""How far the ssm wave's first-token logits move with B8's arithmetic.

``chip_smoke.py`` holds the first-token logits of full-width mamba2-130m
(bf16, random weights from seed 0) on its three ssm waves (4 x 2048,
1 x 32768, 4 x 1000; the first prompt of each) to the plain route within
5% of the largest logit. This script computes those logits on the same
prompts by several routes and prints, for each wave, the largest
difference of each from the kernel route that the model's path takes:

* ``plain``: the plain route (``attn_impl="plain"``), the check's
  reference;
* ``scaled_1e-7`` ... ``scaled_1e-5``: the kernel route with B8's output
  (y and states) times 1 + eps, a change of B8's arithmetic at the size
  of fp32 rounding and above;
* ``fp32``: the same weights in fp32 through the plain route (closer to
  exact arithmetic than either bf16 route);

and the plain route's own difference from ``fp32``, beside the 5%
limit. Run from the repository root on a machine
with a CUDA card and ``nvcc`` (~1 min):

    python3 scripts/ssm_logits_sensitivity.py
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ARCH = "mamba2-130m"
# chip_smoke.py's ssm waves (prompt length, batch) and their prompts: from
# numpy.random.default_rng(5), after the four 300-token warm-up prompts
WAVES = ((2048, 4), (32768, 1), (1000, 4))
WARMUP = (300, 4)
LOGITS_RTOL = 5e-2
EPS = (1e-7, 1e-6, 1e-5)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", dtype=torch.bfloat16)
    plain = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    cfg32 = dataclasses.replace(cfg, attn_impl="plain",
                                compute_dtype=torch.float32)
    m32 = build_model(cfg32)
    p32 = {"embed": params["embed"].float(),
           "final_norm": params["final_norm"].float(),
           "layers": [{k: {n: t.float() for n, t in blk.items()}
                       for k, blk in layer.items()}
                      for layer in params["layers"]]}
    rng = np.random.default_rng(5)

    def prompts(n: int, b: int) -> list:
        return [rng.integers(3, cfg.vocab_size, size=(n,)).astype(np.int32)
                for _ in range(b)]

    prompts(*WARMUP)
    firsts = [prompts(n, b)[0] for n, b in WAVES]
    on_path = ssd.ssd_intra_chunk

    def logits(m, p, c, prompt, n):
        return m.prefill(p, c, prompt, n)[0].float()

    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    for (n, _), first in zip(WAVES, firsts):
        prompt = torch.from_numpy(first[None].astype(np.int64)).to("cuda")
        path = logits(model, params, cfg, prompt, n)
        out = {"plain": logits(plain, params, plain.cfg, prompt, n)}
        for eps in EPS:
            def scaled(*t, eps=eps, **kw):
                y, states = on_path(*t, **kw)
                return y * (1 + eps), states * (1 + eps)
            ssd.ssd_intra_chunk = scaled
            out[f"scaled_{eps:g}"] = logits(model, params, cfg, prompt, n)
        ssd.ssd_intra_chunk = on_path
        out["fp32"] = logits(m32, p32, cfg32, prompt, n)
        scale = float(out["plain"].abs().max())

        def diff(a, b):
            return float((a - b).abs().max())

        print(json.dumps({
            "prompt_len": n, "limit": LOGITS_RTOL * max(1.0, scale),
            "from_path": {k: diff(v, path) for k, v in out.items()},
            "plain_from_fp32": diff(out["plain"], out["fp32"]),
        }), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
