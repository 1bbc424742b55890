"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the reference ``init`` pytree with its leaves
already converted to numpy arrays (``jax.tree.map(np.asarray, params)``),
so this module needs no JAX. The reference stacks the decoder layers
over a leading ``units`` axis (``units["b0"]`` for a pure-attention or a
pure-SSD stack); the port keeps one dict per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import ArchConfig

_ATTN = ("norm", "wq", "wk", "wv", "wo")
_QK_NORM = ("q_norm", "k_norm")
_FFN = ("norm", "w_gate", "w_up", "w_down")
_SSD = ("norm", "w_in", "conv_w", "dt_bias", "a_log", "d_skip", "gate_norm",
        "w_out")


def params_from_jax(tree, cfg: ArchConfig, *, device="cuda") -> dict:
    """The reference's dense-decoder or SSM params as the port's params
    dict, in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dt = cfg.param_dtype

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    if set(tree["units"]) != {"b0"} or "tail" in tree:
        raise ValueError("expected a pure-attention or pure-SSD stack "
                         "(units['b0'] only)")
    unit = tree["units"]["b0"]
    if cfg.family == "ssm":
        blocks = {"ssd": _SSD}
    else:
        blocks = {"attn": _ATTN + (_QK_NORM if cfg.qk_norm else ()),
                  "ffn": _FFN}
    if set(unit) != set(blocks):
        raise ValueError(f"the tree's blocks {sorted(unit)} are not "
                         f"{cfg.name}'s {sorted(blocks)}")
    first, keys = next(iter(blocks.items()))
    n_layers = np.asarray(unit[first][keys[0]]).shape[0]
    if n_layers != cfg.num_layers:
        raise ValueError(f"{n_layers} layers in the tree, "
                         f"{cfg.num_layers} in {cfg.name}")
    layers = [{blk: {k: tensor(np.asarray(unit[blk][k])[i]) for k in keys}
               for blk, keys in blocks.items()}
              for i in range(n_layers)]
    return {"embed": tensor(tree["embed"]),
            "final_norm": tensor(tree["final_norm"]), "layers": layers}
