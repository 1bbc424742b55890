"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the reference ``init`` pytree with its leaves
already converted to numpy arrays (``jax.tree.map(np.asarray, params)``),
so this module needs no JAX. The reference stacks the decoder layers of
each position of its repeating unit over a leading ``units`` axis
(``units["b0"]`` for a pure-attention or a pure-SSD stack;
``units["b0"]`` to ``units["b2"]`` for the hybrid's (rec, rec, attn)
unit) and keeps the tail's layers unstacked (``tail["t0"]``, ...); the
port keeps one dict per layer in stack order: unit u's block j is layer
u * len(pattern) + j, and tail block j follows the units. An MoE layer's
``ffn`` is the router and the routed experts, with ``num_shared`` a
nested ``shared`` SwiGLU, and no norm; a GELU MLP has no ``w_gate``;
untied embeddings carry ``unembed``. An encoder-decoder's attention
layers each hold a ``cross`` block (``norm, wq, wk, wv, wo``, no
qk-norm), and its encoder is ``params["encoder"]``, ``{"attn", "ffn"}``
stacked over the encoder's layers, which the port keeps as one dict a
layer, with ``enc_final_norm`` beside it.

Any tree of the parameters' structure converts the same way, leaf for
leaf: the reference's gradients (``jax.grad`` of ``Model.loss_fn``) and
its AdamW moments (``mu``, ``nu``), which the training tests hold the
port's to.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import ArchConfig

_ATTN = ("norm", "wq", "wk", "wv", "wo")
_QK_NORM = ("q_norm", "k_norm")
_FFN = ("norm", "w_gate", "w_up", "w_down")
_GELU_FFN = ("norm", "w_up", "w_down")
_MOE = ("router", "w_gate", "w_up", "w_down")
_SHARED = ("w_gate", "w_up", "w_down")
_SSD = ("norm", "w_in", "conv_w", "dt_bias", "a_log", "d_skip", "gate_norm",
        "w_out")
_REC = ("norm", "w_x", "w_gate", "conv_w", "w_i", "w_r", "lam", "w_out")


def _blocks(cfg: ArchConfig, kind: str) -> dict:
    """The sub-blocks of a layer of ``kind`` and the keys of each."""
    if kind == "ssd":
        return {"ssd": _SSD}
    ffn = _FFN if cfg.mlp == "swiglu" else _GELU_FFN
    if kind == "rec":
        return {"rec": _REC, "ffn": ffn}
    attn = _ATTN + (_QK_NORM if cfg.qk_norm else ())
    if kind == "encoder":
        return {"attn": attn, "ffn": ffn}
    if cfg.moe is not None:
        ffn = _MOE + (("shared",) if cfg.moe.num_shared else ())
    blocks = {"attn": attn, "ffn": ffn}
    if cfg.encoder_layers:
        blocks["cross"] = _ATTN
    return blocks


def params_from_jax(tree, cfg: ArchConfig, *, device="cuda") -> dict:
    """The reference's dense, MoE, SSM, hybrid, vision-frontend or
    encoder-decoder params as the port's params dict, in
    ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dt = cfg.param_dtype

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    kinds = cfg.layer_kinds
    n_tail = len(cfg.pattern_tail)
    if cfg.family == "ssm":
        pattern: tuple[str, ...] = ("ssd",)
    else:
        pattern = cfg.block_pattern or ("attn",)
    tail = tree.get("tail", {})
    if (set(tree["units"]) != {f"b{j}" for j in range(len(pattern))}
            or set(tail) != {f"t{j}" for j in range(n_tail)}):
        raise ValueError(f"the tree's units {sorted(tree['units'])} and tail "
                         f"{sorted(tail)} are not {cfg.name}'s pattern "
                         f"{pattern} and tail {cfg.pattern_tail}")

    def check(node, kind: str, where: str) -> None:
        blocks = _blocks(cfg, kind)
        if set(node) != set(blocks):
            raise ValueError(f"{where} holds blocks {sorted(node)}, not "
                             f"{cfg.name}'s {sorted(blocks)}")
        for blk, keys in blocks.items():
            if set(node[blk]) != set(keys):
                raise ValueError(f"{where}'s {blk} holds "
                                 f"{sorted(node[blk])}, not {cfg.name}'s "
                                 f"{sorted(keys)}")

    for j, kind in enumerate(pattern):
        check(tree["units"][f"b{j}"], kind, f"units['b{j}']")
    for j, kind in enumerate(cfg.pattern_tail):
        check(tail[f"t{j}"], kind, f"tail['t{j}']")
    if ("encoder" in tree) != bool(cfg.encoder_layers):
        raise ValueError(f"the tree's encoder does not match {cfg.name}'s "
                         f"encoder_layers={cfg.encoder_layers}")
    if cfg.encoder_layers:
        check(tree["encoder"], "encoder", "encoder")
        n_enc = np.asarray(tree["encoder"]["attn"]["wq"]).shape[0]
        if n_enc != cfg.encoder_layers:
            raise ValueError(f"{n_enc} encoder layers in the tree, "
                             f"{cfg.encoder_layers} in {cfg.name}")
    b0 = tree["units"]["b0"]
    first = next(iter(b0))
    n_units = np.asarray(b0[first][next(iter(b0[first]))]).shape[0]
    if n_units * len(pattern) + n_tail != len(kinds):
        raise ValueError(f"{n_units} units of {len(pattern)} and {n_tail} "
                         f"tail layers in the tree, {len(kinds)} layers in "
                         f"{cfg.name}")

    def layer_of(node, i=None):
        if isinstance(node, dict):
            return {k: layer_of(v, i) for k, v in node.items()}
        return tensor(np.asarray(node) if i is None else np.asarray(node)[i])

    layers = [layer_of(tree["units"][f"b{j}"], u)
              for u in range(n_units) for j in range(len(pattern))]
    layers += [layer_of(tail[f"t{j}"]) for j in range(n_tail)]
    params = {"embed": tensor(tree["embed"]),
              "final_norm": tensor(tree["final_norm"]), "layers": layers}
    if ("unembed" in tree) == cfg.tie_embeddings:
        raise ValueError(f"the tree's unembed does not match {cfg.name}'s "
                         f"tie_embeddings={cfg.tie_embeddings}")
    if not cfg.tie_embeddings:
        params["unembed"] = tensor(tree["unembed"])
    if cfg.encoder_layers:
        params["encoder"] = [layer_of(tree["encoder"], i)
                             for i in range(cfg.encoder_layers)]
        params["enc_final_norm"] = tensor(tree["enc_final_norm"])
    return params


def reference_leaf(path: str, cfg: ArchConfig) -> str:
    """The path of the reference's array that holds the port's leaf at
    ``path`` (``tree.leaves_with_paths``): layer u * len(pattern) + j
    lies in ``units/b{j}`` (stacked over u), a tail layer in ``tail/t{j}``,
    every encoder layer in ``encoder``; the rest keep their path. A
    leading ``params/`` or other prefix before ``layers`` or ``encoder``
    is kept."""
    parts = path.split("/")
    for at, name in enumerate(parts[:-1]):
        if name not in ("layers", "encoder") or not parts[at + 1].isdigit():
            continue
        head, i, rest = parts[:at], int(parts[at + 1]), parts[at + 2:]
        if name == "encoder":
            return "/".join(head + ["encoder"] + rest)
        if cfg.family == "ssm":
            pattern = 1
        else:
            pattern = len(cfg.block_pattern or ("attn",))
        body = len(cfg.layer_kinds) - len(cfg.pattern_tail)
        where = (["units", f"b{i % pattern}"] if i < body
                 else ["tail", f"t{i - body}"])
        return "/".join(head + where + rest)
    return path
