"""LoRA / DoRA adapters as trees beside the base parameters.

Counterpart of sd_lora_trainer_tpu/models/lora.py. An adapter set is its own
tree mirroring the targeted module paths (list indices become string keys);
`inject_lora` grafts it into a base param tree, where `dense`/`conv2d` apply
any "lora" subdict they find. Only the adapter tensors require gradients, so
the base weights are frozen by construction. Layouts follow peft/kohya:
a (r, in) [lora_down], b (out, r) [lora_up]; conv a (r, in, kh, kw),
b (out, r, 1, 1).

Export follows the JAX package's kohya contract: keys
`lora_unet_<path with _>.{lora_down.weight,lora_up.weight,alpha}` plus
`lora_te1_`/`lora_te2_` for the text encoders, alpha == rank, float32 in the
layouts above (which are kohya's, so nothing is transposed).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from sd_lora_trainer_tpu_torch.models.layers import _lora_scale

UNET_TARGETS = ("to_q", "to_k", "to_v", "to_out.0", "conv2")
TEXT_ENCODER_TARGETS = ("q_proj", "k_proj", "v_proj", "out_proj")


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


def merge_lora(base_params: dict, lora_params: dict, scale: float = 1.0) -> dict:
    """Fuse adapters into the base weights: W' = W + scale * (alpha / r) * B A
    (DoRA: renormalized per output to the magnitude). An int8 base weight
    (models/quant.py) merges to a dense one in its logical dtype;
    untargeted weights pass through unchanged."""

    def fuse(base, lora):
        if isinstance(base, dict) and "weight" in base and isinstance(lora, dict) and "a" in lora:
            weight = base["weight"]
            a, b = lora["a"].float(), lora["b"].float()
            s = scale * _lora_scale(lora)
            if a.ndim == 2:
                delta = b @ a * s
            else:  # (1x1 B) after (kh x kw A) is one kh x kw kernel
                delta = torch.einsum("or,rihw->oihw", b[:, :, 0, 0], a) * s
            w = weight.float() + delta
            if "magnitude" in lora:
                norm = torch.linalg.norm(w.reshape(w.shape[0], -1), dim=1)
                w = w * (lora["magnitude"] / torch.clamp(norm, min=1e-6)).reshape(
                    (-1,) + (1,) * (w.ndim - 1))
            return dict(base, weight=w.to(weight.dtype))
        if isinstance(base, dict):
            return {k: fuse(v, lora[k]) if (isinstance(lora, dict) and k in lora) else v
                    for k, v in base.items()}
        if isinstance(base, (list, tuple)):
            return [fuse(v, lora[str(i)]) if (isinstance(lora, dict) and str(i) in lora) else v
                    for i, v in enumerate(base)]
        return base

    with torch.no_grad():
        return fuse(base_params, lora_params)


def kohya_state_dict(unet_lora: Optional[dict] = None,
                     te_loras: Optional[List[Optional[dict]]] = None) -> Dict[str, torch.Tensor]:
    """Adapter trees -> the kohya/WebUI state dict (ComfyUI, AUTO1111 and
    sd-scripts load it): float32, contiguous, on the adapters' device; the
    alpha a 0-d tensor equal to the rank, as diffusers' kohya converter
    writes it."""
    sd: Dict[str, torch.Tensor] = {}

    def emit(prefix: str, tree: dict):
        for path, entry in iter_lora_leaves(tree):
            key = prefix + path.replace(".", "_")
            down = entry["a"].detach().float().contiguous()
            sd[f"{key}.lora_down.weight"] = down
            sd[f"{key}.lora_up.weight"] = entry["b"].detach().float().contiguous()
            sd[f"{key}.alpha"] = torch.tensor(float(down.shape[0]), dtype=torch.float32)

    if unet_lora:
        emit("lora_unet_", unet_lora)
    for i, te_lora in enumerate(te_loras or []):
        if te_lora:
            emit(f"lora_te{i + 1}_", te_lora)
    return sd


def _module_paths(tree, path=()):
    """{path joined by '_' with dots as '_': path} of every module dict of a
    base tree, including the projection dicts the fused layout leaves
    without a weight (models/fuse.py)."""
    out = {}
    if isinstance(tree, dict):
        if path:
            out["_".join(map(str, path)).replace(".", "_")] = path
        if "weight" not in tree:
            for k, v in tree.items():
                out.update(_module_paths(v, path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_module_paths(v, path + (i,)))
    return out


def load_kohya_state_dict(sd: Dict[str, torch.Tensor], unet_params: dict,
                          te_params: List[Optional[dict]], device="cuda"
                          ) -> Tuple[dict, List[Optional[dict]]]:
    """A kohya state dict -> (UNet adapter tree, [TE adapter trees]) on
    `device`: the inverse of `kohya_state_dict`, module paths found by
    walking the base trees."""
    unet_map = _module_paths(unet_params)
    te_maps = [_module_paths(te) if te else {} for te in te_params]
    unet_tree: dict = {}
    te_trees: List[Optional[dict]] = [None] * len(te_params)
    groups: Dict[str, dict] = {}
    for key, value in sd.items():
        base_key, _, leaf = key.partition(".")
        groups.setdefault(base_key, {})[leaf] = value
    for base_key, entry in groups.items():
        if base_key.startswith("lora_unet_"):
            flat, target_map, tree_idx = base_key[len("lora_unet_"):], unet_map, None
        elif base_key.startswith("lora_te"):
            tree_idx = int(base_key[len("lora_te")]) - 1
            flat, target_map = base_key[len("lora_teX_"):], te_maps[tree_idx]
        else:
            raise ValueError(f"Unknown kohya key family: {base_key}")
        if flat not in target_map:
            raise KeyError(f"kohya module {base_key} not found in model tree")
        down, up = entry["lora_down.weight"], entry["lora_up.weight"]
        alpha = float(entry["alpha"].reshape(-1)[0]) if "alpha" in entry else float(down.shape[0])
        node = {"a": down.float().to(device), "b": up.float().to(device), "alpha": LoraAlpha(alpha)}
        if tree_idx is None:
            _set_path(unet_tree, target_map[flat], node)
        else:
            if te_trees[tree_idx] is None:
                te_trees[tree_idx] = {}
            _set_path(te_trees[tree_idx], target_map[flat], node)
    return unet_tree, te_trees
