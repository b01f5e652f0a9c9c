"""LoRA / DoRA adapters as trees beside the base parameters.

Counterpart of sd_lora_trainer_tpu/models/lora.py. An adapter set is its own
tree mirroring the targeted module paths (list indices become string keys);
`inject_lora` grafts it into a base param tree, where `dense`/`conv2d` apply
any "lora" subdict they find. Only the adapter tensors require gradients, so
the base weights are frozen by construction. Layouts follow peft/kohya:
a (r, in) [lora_down], b (out, r) [lora_up]; conv a (r, in, kh, kw),
b (out, r, 1, 1). Kohya export is a later slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

UNET_TARGETS = ("to_q", "to_k", "to_v", "to_out.0", "conv2")


class LoraAlpha:
    """The LoRA alpha: a hyperparameter, never an optimizer parameter."""

    def __init__(self, value: float):
        self.value = float(value)

    def __repr__(self):
        return f"LoraAlpha({self.value})"

    def __eq__(self, other):
        return isinstance(other, LoraAlpha) and other.value == self.value

    def __hash__(self):
        return hash(("LoraAlpha", self.value))


def _walk(tree, path=()):
    """Yield (path, module_dict) for every param dict with a weight matrix."""
    if isinstance(tree, dict):
        if "weight" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))


def _set_path(tree: dict, path: Tuple, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(str(p), {})
    node[str(path[-1])] = value


def create_lora_params(
    base_params: dict,
    rank: int,
    generator: torch.Generator,
    alpha_multiplier: float = 1.0,
    targets=UNET_TARGETS,
    use_dora: bool = False,
    dtype=torch.float32,
) -> dict:
    """An adapter tree for every module whose last path name is a target.

    Gaussian init (peft init_lora_weights="gaussian": A ~ N(0, 1/r), B = 0),
    alpha = rank * alpha_multiplier. DoRA adds a "magnitude" vector set to
    the base weight's per-output norms.
    """
    alpha = float(rank * alpha_multiplier)
    leaves = [
        (p, m) for p, m in _walk(base_params)
        if str(p[-1]) in targets and m["weight"].ndim in (2, 4)
    ]
    lora_tree: dict = {}
    for path, module in leaves:
        w = module["weight"]
        device = w.device
        n_out, n_in = w.shape[:2]
        ksz = tuple(w.shape[2:])
        a = torch.randn((rank, n_in) + ksz, generator=generator, dtype=dtype, device=device)
        a = a * (1.0 / rank)
        b = torch.zeros((n_out, rank) + (1,) * len(ksz), dtype=dtype, device=device)
        entry = {"a": a.requires_grad_(), "b": b.requires_grad_(), "alpha": LoraAlpha(alpha)}
        if use_dora:
            norms = torch.linalg.norm(w.float().reshape(n_out, -1), dim=1)
            entry["magnitude"] = norms.to(dtype).requires_grad_()
        _set_path(lora_tree, path, entry)
    return lora_tree


def inject_lora(base_params: dict, lora_params: dict) -> dict:
    """A copy of base_params with "lora" subdicts grafted in (no tensor copies).

    An adapter leaf grafts onto its projection dict, which may lack "weight"
    under the fused qkv/kv layout (models/fuse.py)."""

    def graft(base, lora):
        if isinstance(base, dict) and isinstance(lora, dict) and "a" in lora:
            merged = dict(base)
            merged["lora"] = lora
            return merged
        if isinstance(base, dict):
            return {k: graft(v, lora[k]) if (isinstance(lora, dict) and k in lora) else v
                    for k, v in base.items()}
        if isinstance(base, (list, tuple)):
            return [graft(v, lora[str(i)]) if (isinstance(lora, dict) and str(i) in lora) else v
                    for i, v in enumerate(base)]
        return base

    return graft(base_params, lora_params)


def iter_lora_leaves(tree, path=()):
    """Yield (dotted_path, {a, b, ...}) for every adapter in a lora tree."""
    if isinstance(tree, dict):
        if "a" in tree and "b" in tree:
            yield ".".join(map(str, path)), tree
            return
        for k, v in tree.items():
            yield from iter_lora_leaves(v, path + (k,))
