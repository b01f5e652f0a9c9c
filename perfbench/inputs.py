"""The inputs both sides are handed: the models' weights, the adapters'
initial values and the textual-inversion rows, all made from `--seed` on
the device, and nothing else.

The trees follow the checkpoint's layout (diffusers' module paths; linear
[out, in], conv OIHW), the layout the program loads. Weights are drawn in a
few large calls, one per group, each leaf a view of its group's buffer:
the UNet's kernels (every 2-D and 4-D weight but the boundary convs, the
weights an int8 base replaces, so that its buffer is freed when the program
drops them), every other weight, the token tables, the position tables;
norm scales are ones and biases zeros. Random weights: N(0, 0.02^2), token
tables N(0, 0.014^2), position tables N(0, 0.01^2).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

# the adapter targets of the trainer's recipes (kohya-style UNet LoRA on the
# attention projections and the resnets' second convolution)
LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out.0", "conv2")
_BOUNDARY = ("conv_in", "conv_out")


class _Leaf:
    __slots__ = ("shape", "kind")

    def __init__(self, shape, kind):
        self.shape, self.kind = tuple(shape), kind


def _lin(n_in, n_out, bias=True):
    p = {"weight": _Leaf((n_out, n_in), "w")}
    if bias:
        p["bias"] = _Leaf((n_out,), "zero")
    return p


def _conv(n_in, n_out, k=3):
    return {"weight": _Leaf((n_out, n_in, k, k), "w"), "bias": _Leaf((n_out,), "zero")}


def _norm(c):
    return {"weight": _Leaf((c,), "one"), "bias": _Leaf((c,), "zero")}


def unet_tree(unet: dict) -> dict:
    """The UNet's parameter tree from diffusers' config keys."""
    ch = list(unet["block_out_channels"])
    n = len(ch)
    per = (lambda v: list(v) if isinstance(v, (list, tuple)) else [v] * n)
    depth = per(unet.get("transformer_layers_per_block", 1))
    cross = [t.startswith("CrossAttn") for t in unet["down_block_types"]]
    ctx_dim, lpb, ted = unet["cross_attention_dim"], unet["layers_per_block"], ch[0] * 4
    linear_proj = bool(unet.get("use_linear_projection", False))

    def resnet(cin, cout):
        p = {"norm1": _norm(cin), "conv1": _conv(cin, cout), "time_emb_proj": _lin(ted, cout),
             "norm2": _norm(cout), "conv2": _conv(cout, cout)}
        if cin != cout:
            p["conv_shortcut"] = _conv(cin, cout, 1)
        return p

    def block(c):
        return {
            "norm1": _norm(c),
            "attn1": {"to_q": _lin(c, c, False), "to_k": _lin(c, c, False),
                      "to_v": _lin(c, c, False), "to_out.0": _lin(c, c)},
            "norm2": _norm(c),
            "attn2": {"to_q": _lin(c, c, False), "to_k": _lin(ctx_dim, c, False),
                      "to_v": _lin(ctx_dim, c, False), "to_out.0": _lin(c, c)},
            "norm3": _norm(c),
            "ff.net.0.proj": _lin(c, 8 * c),
            "ff.net.2": _lin(4 * c, c),
        }

    def transformer(c, d):
        proj = (lambda: _lin(c, c)) if linear_proj else (lambda: _conv(c, c, 1))
        return {"norm": _norm(c), "proj_in": proj(),
                "transformer_blocks": [block(c) for _ in range(d)], "proj_out": proj()}

    down, cin = [], ch[0]
    for i, cout in enumerate(ch):
        b = {"resnets": []}
        if cross[i]:
            b["attentions"] = []
        for j in range(lpb):
            b["resnets"].append(resnet(cin if j == 0 else cout, cout))
            if cross[i]:
                b["attentions"].append(transformer(cout, depth[i]))
        if i < n - 1:
            b["downsamplers"] = [{"conv": _conv(cout, cout)}]
        down.append(b)
        cin = cout
    skip = [ch[0]]
    for i, c in enumerate(ch):
        skip += [c] * lpb + ([c] if i < n - 1 else [])
    up, prev = [], ch[-1]
    for i, cout in enumerate(reversed(ch)):
        level = n - 1 - i
        b = {"resnets": []}
        if cross[level]:
            b["attentions"] = []
        for _ in range(lpb + 1):
            b["resnets"].append(resnet(prev + skip.pop(), cout))
            if cross[level]:
                b["attentions"].append(transformer(cout, depth[level]))
            prev = cout
        if i < n - 1:
            b["upsamplers"] = [{"conv": _conv(cout, cout)}]
        up.append(b)
    tree = {
        "conv_in": _conv(unet["in_channels"], ch[0]),
        "time_embedding": {"linear_1": _lin(ch[0], ted), "linear_2": _lin(ted, ted)},
        "down_blocks": down,
        "mid_block": {"resnets": [resnet(ch[-1], ch[-1]), resnet(ch[-1], ch[-1])],
                      "attentions": [transformer(ch[-1], depth[-1])]},
        "up_blocks": up,
        "conv_norm_out": _norm(ch[0]),
        "conv_out": _conv(ch[0], unet["out_channels"]),
    }
    if unet.get("addition_embed_type") == "text_time":
        tree["add_embedding"] = {
            "linear_1": _lin(unet["projection_class_embeddings_input_dim"], ted),
            "linear_2": _lin(ted, ted)}
    return tree


def clip_tree(te: dict) -> dict:
    d, ffn = te["hidden_size"], te["intermediate_size"]
    layers = [{"layer_norm1": _norm(d),
               "self_attn": {k: _lin(d, d) for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
               "layer_norm2": _norm(d),
               "mlp": {"fc1": _lin(d, ffn), "fc2": _lin(ffn, d)}}
              for _ in range(te["num_hidden_layers"])]
    tree = {"text_model": {
        "embeddings": {"token_embedding": {"weight": _Leaf((te["vocab_size"], d), "tok")},
                       "position_embedding": {"weight": _Leaf((te["max_position_embeddings"], d),
                                                              "pos")}},
        "encoder": {"layers": layers},
        "final_layer_norm": _norm(d)}}
    if te.get("projection_dim"):
        tree["text_projection"] = {"weight": _Leaf((te["projection_dim"], d), "w")}
    return tree


def vae_tree(vae: dict) -> dict:
    """The VAE's decoder and post-quant conv (what a render runs), from
    diffusers' `vae/config.json` keys."""
    ch = list(reversed(vae["block_out_channels"]))
    lpb = vae["layers_per_block"]
    lat = vae["latent_channels"]

    def resnet(cin, cout):
        p = {"norm1": _norm(cin), "conv1": _conv(cin, cout), "norm2": _norm(cout),
             "conv2": _conv(cout, cout)}
        if cin != cout:
            p["conv_shortcut"] = _conv(cin, cout, 1)
        return p

    up, cin = [], ch[0]
    for i, cout in enumerate(ch):
        b = {"resnets": [resnet(cin if j == 0 else cout, cout) for j in range(lpb + 1)]}
        if i < len(ch) - 1:
            b["upsamplers"] = [{"conv": _conv(cout, cout)}]
        up.append(b)
        cin = cout
    attn = {"group_norm": _norm(ch[0]), **{k: _lin(ch[0], ch[0])
                                           for k in ("to_q", "to_k", "to_v", "to_out")}}
    return {
        "decoder": {"conv_in": _conv(lat, ch[0]),
                    "mid_block": {"resnets": [resnet(ch[0], ch[0]), resnet(ch[0], ch[0])],
                                  "attentions": [attn]},
                    "up_blocks": up, "conv_norm_out": _norm(ch[-1]),
                    "conv_out": _conv(ch[-1], vae["out_channels"])},
        "post_quant_conv": _conv(lat, lat, 1),
    }


def walk(tree, path=()):
    """(path tuple, leaf) of every leaf, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from walk(v, path + (str(i),))
    else:
        yield path, tree


def _set(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    if isinstance(node, list):
        node[int(path[-1])] = value
    else:
        node[path[-1]] = value


_STD = {"unet_kernel": 0.02, "w": 0.02, "tok": 0.014, "pos": 0.01}


def materialize(trees: Dict[str, dict], gen: Optional[torch.Generator], dtype, device) -> None:
    """Replace every placeholder leaf of `trees` (in place) by a view of its
    group's buffer: one draw per random group, in a fixed order."""
    groups: Dict[str, List[Tuple[dict, tuple, _Leaf]]] = {}
    for name, tree in trees.items():
        for path, leaf in walk(tree):
            kind = leaf.kind
            if (name == "unet" and kind == "w" and path[-1] == "weight" and len(leaf.shape) in (2, 4)
                    and path[-2] not in _BOUNDARY):
                kind = "unet_kernel"
            groups.setdefault(kind, []).append((tree, path, leaf))
    for kind in ("unet_kernel", "w", "tok", "pos", "one", "zero"):
        members = groups.get(kind, [])
        sizes = [int(torch.Size(leaf.shape).numel()) for _, _, leaf in members]
        total = sum(sizes)
        if not total:
            continue
        if device == "meta" or str(device) == "meta":
            flat = torch.empty(total, dtype=dtype, device="meta")
        elif kind == "one":
            flat = torch.ones(total, dtype=dtype, device=device)
        elif kind == "zero":
            flat = torch.zeros(total, dtype=dtype, device=device)
        else:
            flat = torch.randn(total, generator=gen, dtype=dtype, device=device).mul_(_STD[kind])
        for (tree, path, leaf), part in zip(members, torch.split(flat, sizes)):
            _set(tree, path, part.view(leaf.shape))


def lora_sites(unet: dict) -> Dict[str, Tuple[int, ...]]:
    """{module path: base weight shape} of every adapted module."""
    out = {}
    for path, leaf in walk(unet):
        if path[-1] == "weight" and path[-2] in LORA_TARGETS and len(leaf.shape) in (2, 4):
            out[".".join(path[:-1])] = tuple(leaf.shape)
    return out


def make_inputs(config: dict, seed: int, device, dtype=torch.bfloat16, rank: int = 16,
                n_tokens: int = 3, vae: bool = False, lora_b_std: float = 0.0) -> dict:
    """Everything both sides start from: {"unet", "te1", "te2" (or None),
    "vae" (with `vae`), "lora_a": {site: A}, "lora_b" (with `lora_b_std`),
    "lora_shapes": {site: weight shape}, "ti": {"te1": rows, "te2": rows}}.
    The adapters' A is N(0, 1/rank^2) (peft's gaussian init) and B is 0, or
    N(0, lora_b_std^2) for adapters that stand for trained ones; a TI row set
    is N(0, 1) rescaled to the mean per-row std of its encoder's token
    table."""
    meta = str(device) == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(int(seed))
    trees = {"unet": unet_tree(config["unet"]), "te1": clip_tree(config["text_encoder"])}
    if config.get("text_encoder_2"):
        trees["te2"] = clip_tree(config["text_encoder_2"])
    if vae:
        trees["vae"] = vae_tree(config["vae"])
    sites = lora_sites(trees["unet"])
    materialize(trees, gen, dtype, device)
    names = sorted(sites)
    shapes = [(rank, s[1]) + tuple(s[2:]) for s in (sites[n] for n in names)]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    if meta:
        flat = torch.empty(sum(sizes), device="meta")
    else:
        flat = torch.randn(sum(sizes), generator=gen, dtype=torch.float32, device=device) / rank
    lora_a = {n: part.view(s).clone() for n, s, part in zip(names, shapes, torch.split(flat, sizes))}
    lora_b = {}
    if lora_b_std:
        b_shapes = [(s[0], rank) + (1,) * (len(s) - 2) for s in (sites[n] for n in names)]
        b_sizes = [int(torch.Size(s).numel()) for s in b_shapes]
        flat = (torch.empty(sum(b_sizes), device="meta") if meta else
                torch.randn(sum(b_sizes), generator=gen, dtype=torch.float32, device=device)
                * lora_b_std)
        lora_b = {n: part.view(s).clone()
                  for n, s, part in zip(names, b_shapes, torch.split(flat, b_sizes))}
    ti = {}
    for which in ("te1", "te2"):
        if which not in trees:
            continue
        table = trees[which]["text_model"]["embeddings"]["token_embedding"]["weight"]
        if meta:
            ti[which] = torch.empty(n_tokens, table.shape[1], device="meta")
            continue
        target = table.float().std(dim=1, correction=0).mean()
        rows = torch.randn(n_tokens, table.shape[1], generator=gen, dtype=torch.float32,
                           device=device)
        ti[which] = rows * target / rows.std(dim=1, correction=0).mean()
    return {"unet": trees["unet"], "te1": trees["te1"], "te2": trees.get("te2"),
            "vae": trees.get("vae"), "lora_a": lora_a, "lora_b": lora_b, "lora_shapes": sites,
            "ti": ti}
