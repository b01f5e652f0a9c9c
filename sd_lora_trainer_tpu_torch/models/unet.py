"""UNet2DCondition (SD1.5 + SDXL) over parameter dicts.

Counterpart of sd_lora_trainer_tpu/models/unet.py: one implementation
parameterized by `UNetConfig` covers SD1.5 and SDXL (text_time additional
embeddings). The public `unet_forward` takes NHWC latents like the JAX one;
inside, activations stay NHWC in memory and the convs read them as
channels-last NCHW views. Every down/up-block cross-attention can emit DAAM
scores under `{name}.transformer_blocks.{i}.attn2`.

`remat` is the JAX package's memory plan for each down/mid/up layer, as
`torch.utils.checkpoint` (non-reentrant) regions: True recomputes every layer
in the backward, False none; "light" recomputes the attention-bearing layers
only; "dots" keeps the outputs of the matmuls without batch dims (mm/addmm);
"save:<names>" keeps the named activations and recomputes the rest;
"light+save:<names>" is "light" whose attention layers keep the named ones.
Names (`attn_out`, `xattn_out`, `ff_hidden`, `flash_out`, `flash_lse`, each
with its level's `_c{channels}`; a trailing '*' expands over the levels) are
attached to the ops that produce them (ops/checkpoint_names.py); a kept op is
not run again in the backward. `stash8` keeps the listed names as row-wise
int8 (ops/stash8.py). "offload:<names>" keeps them in pinned host memory
instead, and "light+offload:<names>" composes as "light+save:" does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from sd_lora_trainer_tpu_torch.models.layers import (
    _apply_lora_dense,
    conv2d,
    dense,
    gelu,
    group_norm,
    layer_norm,
    silu,
    timestep_embedding,
    upsample_nearest_2x,
)
from sd_lora_trainer_tpu_torch.ops.attention import multihead_attention, self_attention
from sd_lora_trainer_tpu_torch.ops.checkpoint_names import saving_names
from sd_lora_trainer_tpu_torch.ops.flash_attention import _pad_plan, flash_attention_qualifies
from sd_lora_trainer_tpu_torch.ops.stash8 import expand_names, stash8 as stash8_op


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    cross_attention: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    transformer_layers: Tuple[int, ...] = (1, 1, 1, 0)
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    mid_transformer_layers: int = 1
    mid_num_heads: int = 8
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    addition_embed_dim: Optional[int] = None  # 256 for SDXL
    addition_pooled_dim: Optional[int] = None  # 1280 for SDXL
    addition_time_ids: int = 6

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def addition_input_dim(self) -> Optional[int]:
        if self.addition_embed_dim is None:
            return None
        return self.addition_pooled_dim + self.addition_embed_dim * self.addition_time_ids


SD15_UNET_CONFIG = UNetConfig()

SDXL_UNET_CONFIG = UNetConfig(
    block_out_channels=(320, 640, 1280),
    cross_attention=(False, True, True),
    transformer_layers=(0, 2, 10),
    num_heads=(5, 10, 20),
    mid_transformer_layers=10,
    mid_num_heads=20,
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_dim=256,
    addition_pooled_dim=1280,
)

TINY_SDXL_UNET_CONFIG = UNetConfig(
    block_out_channels=(32, 64, 64),
    cross_attention=(False, True, True),
    layers_per_block=1,
    transformer_layers=(0, 1, 2),
    num_heads=(1, 2, 2),
    mid_transformer_layers=1,
    mid_num_heads=2,
    cross_attention_dim=64,
    use_linear_projection=True,
    norm_num_groups=8,
    addition_embed_dim=8,
    addition_pooled_dim=32,
)

TINY_SD15_UNET_CONFIG = UNetConfig(
    block_out_channels=(32, 64, 64, 64),
    cross_attention=(True, True, True, False),
    layers_per_block=1,
    transformer_layers=(1, 1, 1, 0),
    num_heads=(2, 2, 2, 2),
    mid_transformer_layers=1,
    mid_num_heads=2,
    cross_attention_dim=48,
    use_linear_projection=False,
    norm_num_groups=8,
)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _resnet(p: dict, x: torch.Tensor, temb: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv2d(p["conv1"], group_norm(p["norm1"], x, groups, silu=True), padding=1)
    t = dense(p["time_emb_proj"], silu(temb))  # [B, C]
    h = h + t[:, None, None, :].to(h.dtype)
    h = conv2d(p["conv2"], group_norm(p["norm2"], h, groups, silu=True), padding=1)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding="VALID")
    return x + h


def _module_pad_len(b: int, ntok: int, c: int, heads: int, use_flash: bool, device) -> int:
    """Padded token count for a spatial transformer, or 0 for no padding.

    Ragged bucket lengths are padded ONCE per module: every block then runs
    at the padded length (LN/FF/residuals are row-local, self-attention masks
    the pad tokens via segment ids, cross-attention pad rows are sliced off at
    module exit with zero cotangent).
    """
    if not use_flash or not flash_attention_qualifies((b, ntok, c), (b, ntok, c), heads, device):
        return 0
    lp = _pad_plan(ntok)[0]
    return lp if lp != ntok else 0


def _tag(x: torch.Tensor, name: str, stash8_names=frozenset()) -> torch.Tensor:
    """x as a row-wise int8 stash named `name` when the name is stashed, else
    x itself: an unstashed name is attached to x's producer instead (see
    `_producer_name`), since naming x after the fact elides nothing."""
    return stash8_op(x, name) if name in stash8_names else x


def _producer_name(name: str, stash8_names) -> Optional[str]:
    """The name for the op producing the tensor: none when it is stashed (the
    int8 pair is kept, not the producer's output)."""
    return None if name in stash8_names else name


def _transformer_block(
    p: dict,
    x: torch.Tensor,  # [B, L, C]
    ctx: torch.Tensor,  # [B, 77, cross_dim]
    heads: int,
    capture: bool,
    use_flash: bool,
    stash8_names=frozenset(),
    pre_padded: int = 0,
):
    # the channel suffix lets a plan target one resolution level at a time
    tag = f"_c{x.shape[-1]}"
    h = layer_norm(p["norm1"], x)
    a1 = p["attn1"]
    # a tensor-parallel block (parallel/sharding.py): every projection into
    # the heads and the GEGLU is split by output features, so each rank runs
    # its own heads, and the inputs enter the model group once
    tp = a1.get("to_q", {}).get("tp")
    enter = tp.enter if tp is not None else (lambda t: t)
    if tp is not None:
        heads //= tp.group.size
        h = enter(h)
    if "qkv" in a1:
        # fused layout (models/fuse.py): one matmul; LoRA deltas per slice
        q, k, v = F.linear(h, a1["qkv"]["weight"].to(h.dtype)).chunk(3, dim=-1)
        if "lora" in a1.get("to_q", {}):
            q = _apply_lora_dense(a1["to_q"], h, q)
        if "lora" in a1.get("to_k", {}):
            k = _apply_lora_dense(a1["to_k"], h, k)
        if "lora" in a1.get("to_v", {}):
            v = _apply_lora_dense(a1["to_v"], h, v)
    else:
        q = dense(a1["to_q"], h)
        k = dense(a1["to_k"], h)
        v = dense(a1["to_v"], h)
    name = f"attn_out{tag}"
    attn = self_attention(
        q, k, v, heads, use_flash=use_flash, pre_padded=pre_padded, name_tag=tag,
        stash8_out=f"flash_out{tag}" in stash8_names,
        out_name=_producer_name(name, stash8_names),
    )
    attn = _tag(attn, name, stash8_names)
    x = x + dense(a1["to_out.0"], attn)

    h = layer_norm(p["norm2"], x)
    a2 = p["attn2"]
    q = dense(a2["to_q"], enter(h))
    if tp is not None:
        ctx = enter(ctx)
    if "kv" in a2:
        k, v = F.linear(ctx, a2["kv"]["weight"].to(ctx.dtype)).chunk(2, dim=-1)
        if "lora" in a2.get("to_k", {}):
            k = _apply_lora_dense(a2["to_k"], ctx, k)
        if "lora" in a2.get("to_v", {}):
            v = _apply_lora_dense(a2["to_v"], ctx, v)
    else:
        k = dense(a2["to_k"], ctx)
        v = dense(a2["to_v"], ctx)
    # a tag of its own: the self-attention's attn_out holds flash_out's bytes
    name = f"xattn_out{tag}"
    attn, scores = multihead_attention(q, k, v, heads, capture_scores=capture,
                                       out_name=_producer_name(name, stash8_names))
    if scores is not None and tp is not None:
        scores = tp.exit(scores)  # the head sum over every rank's heads
    if scores is not None and pre_padded:
        scores = scores[:, :pre_padded]  # DAAM consumers need q_len == h*w
    attn = _tag(attn, name, stash8_names)
    x = x + dense(a2["to_out.0"], attn)

    # GEGLU feed-forward
    h = enter(layer_norm(p["norm3"], x))
    name = f"ff_hidden{tag}"
    h2 = _tag(dense(p["ff.net.0.proj"], h, name=_producer_name(name, stash8_names)), name,
              stash8_names)
    a, b = h2.chunk(2, dim=-1)
    x = x + dense(p["ff.net.2"], a * gelu(b))
    return x, scores


def _spatial_transformer(p, x, ctx, cfg: UNetConfig, heads: int, name: str, capture: bool,
                         use_flash: bool, stash8_names=frozenset()):
    """Transformer2DModel: GN -> proj_in -> blocks -> proj_out -> residual."""
    b, hh, ww, c = x.shape
    residual = x
    h = group_norm(p["norm"], x, cfg.norm_num_groups)
    ntok = hh * ww
    if cfg.use_linear_projection:
        h = dense(p["proj_in"], h.reshape(b, ntok, c))
    else:
        h = conv2d(p["proj_in"], h, padding="VALID").reshape(b, ntok, c)
    pad_to = _module_pad_len(b, ntok, c, heads, use_flash, x.device)
    if pad_to:
        h = F.pad(h, (0, 0, 0, pad_to - ntok))
    scores_out = {}
    for i, bp in enumerate(p["transformer_blocks"]):
        h, scores = _transformer_block(
            bp, h, ctx, heads, capture, use_flash, stash8_names, pre_padded=ntok if pad_to else 0
        )
        if scores is not None:
            scores_out[f"{name}.transformer_blocks.{i}.attn2"] = scores
    if pad_to:
        h = h[:, :ntok]
    if cfg.use_linear_projection:
        h = dense(p["proj_out"], h).reshape(b, hh, ww, c)
    else:
        h = conv2d(p["proj_out"], h.reshape(b, hh, ww, c), padding="VALID")
    return residual + h, scores_out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _checkpointed(context_fn=None):
    """Wrap for a layer recomputed in the backward (non-reentrant checkpoint);
    `context_fn` makes a selective policy's contexts. The UNet draws no
    random numbers, so no generator state is stashed for the recompute
    (reading the CUDA generator's state is refused while a step is captured)."""
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return lambda f: (lambda *args: checkpoint(f, *args, use_reentrant=False,
                                               preserve_rng_state=False, **kw))


def _named_policy_remat(spec: str, cfg: UNetConfig):
    """Named-activation remat: full recompute except the ops that produce the
    listed names, whose outputs are kept on the device ("save:<names>") or
    in pinned host memory ("offload:<names>")."""
    kind, _, raw = spec.partition(":")
    if kind not in ("save", "offload"):
        raise ValueError(f"unknown named remat policy {spec!r}: expected 'save:<names>' or "
                         "'offload:<names>'")
    names = frozenset(expand_names(raw, cfg.block_out_channels))
    return _checkpointed(saving_names(names, offload=kind == "offload"))


# the outputs "dots" keeps: matmuls without batch dims (JAX's
# dots_with_no_batch_dims_saveable), not bmm
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrappers(remat, cfg: UNetConfig):
    """(wrap of the attention-bearing layers and the mid block, wrap of the
    plain resnet layers) for a remat plan, as the JAX `unet_forward` splits
    them into `maybe_remat` and `remat_plain`."""
    def keep(f):
        return f

    if isinstance(remat, str) and remat.startswith(("light+save:", "light+offload:")):
        # plain resnet layers keep all activations, attention layers the named ones
        return _named_policy_remat(remat.partition("+")[2], cfg), keep
    if isinstance(remat, str) and remat.startswith(("save:", "offload:")):
        wrap = _named_policy_remat(remat, cfg)
        return wrap, wrap
    if remat == "dots":
        # every op of the region passes the policy: torch's selective contexts
        wrap = _checkpointed(lambda: create_selective_checkpoint_contexts(_save_dots))
        return wrap, wrap
    if remat == "light":
        return _checkpointed(), keep
    if isinstance(remat, str):
        # a typo'd plan silently running full remat would mislead a measurement
        raise ValueError(
            f"unknown remat policy {remat!r}: expected True/False, 'light', 'dots', "
            "'save:<names>', 'offload:<names>', 'light+save:<names>', 'light+offload:<names>'"
        )
    if remat:
        wrap = _checkpointed()
        return wrap, wrap
    return keep, keep


def unet_forward(
    params: dict,
    latents: torch.Tensor,  # [B, H, W, 4]
    timesteps: torch.Tensor,  # [B]
    encoder_hidden_states: torch.Tensor,  # [B, 77, cross_dim]
    cfg: UNetConfig,
    added_cond: Optional[dict] = None,  # {"text_embeds": [B,1280], "time_ids": [B,6]}
    capture_attn: bool = False,
    use_flash: bool = True,
    remat=True,
    stash8: str = "",  # comma list of names kept as row-wise int8 (ops/stash8.py)
    gather=None,  # fsdp: param subtree -> whole tensors (parallel/sharding.py)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Predict noise. Returns (eps_pred [B,H,W,4], attn_scores dict).

    attn_scores holds, with capture_attn=True, the head-summed scaled QK^T
    logits of every down/up-block cross-attention (the mid block is skipped).

    `gather` (fsdp) turns a subtree of parameter shards into whole tensors:
    each down/mid/up layer gathers its own, in one collective, inside its
    remat region, so the recompute gathers again and no whole weight
    outlives its layer there.
    """
    ctx = encoder_hidden_states
    groups = cfg.norm_num_groups
    if stash8:
        if not (isinstance(remat, str) and "save:" in remat):
            # quantizing without a plan that keeps the stash only loses precision
            raise ValueError(
                f"stash8={stash8!r} requires a 'save:'-family remat plan whose names "
                f"include the stashed ones, got remat={remat!r}"
            )
        stash8_names = frozenset(expand_names(stash8, cfg.block_out_channels))
    else:
        stash8_names = frozenset()
    maybe_remat, remat_plain = _remat_wrappers(remat, cfg)
    P = gather if gather is not None else (lambda tree: tree)

    t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
    te = P(params["time_embedding"])
    temb = dense(te["linear_2"], silu(dense(te["linear_1"], t_emb)))
    if cfg.addition_embed_dim is not None:
        if added_cond is None:
            raise ValueError("the SDXL UNet needs added_cond text_embeds/time_ids")
        add_t = timestep_embedding(added_cond["time_ids"].reshape(-1), cfg.addition_embed_dim)
        add_t = add_t.reshape(temb.shape[0], -1)
        add_emb = torch.cat([added_cond["text_embeds"].to(add_t.dtype), add_t], dim=-1)
        ae = P(params["add_embedding"])
        temb = temb + dense(ae["linear_2"], silu(dense(ae["linear_1"], add_emb)))
    temb = temb.to(latents.dtype)

    x = conv2d(P(params["conv_in"]), latents, padding=1)
    skips = [x]
    attn_scores: Dict[str, torch.Tensor] = {}

    for i in range(len(cfg.block_out_channels)):
        bp = params["down_blocks"][i]
        has_attn = cfg.cross_attention[i]
        for j in range(cfg.layers_per_block):
            layer_params = {"resnet": bp["resnets"][j]}
            if has_attn:
                layer_params["attention"] = bp["attentions"][j]

            def down_layer(layer_params, x, temb, ctx, i=i, has_attn=has_attn,
                           name=f"down_blocks.{i}.attentions.{j}"):
                scores = {}
                layer_params = P(layer_params)
                x = _resnet(layer_params["resnet"], x, temb, groups)
                if has_attn:
                    x, scores = _spatial_transformer(
                        layer_params["attention"], x, ctx, cfg, cfg.num_heads[i], name,
                        capture_attn, use_flash, stash8_names,
                    )
                return x, scores

            wrap = maybe_remat if has_attn else remat_plain
            x, scores = wrap(down_layer)(layer_params, x, temb, ctx)
            attn_scores.update(scores)
            skips.append(x)
        if "downsamplers" in bp:
            x = conv2d(P(bp["downsamplers"][0]["conv"]), x, stride=2, padding=1)
            skips.append(x)

    def mid_fn(mid, x, temb, ctx):
        scores = {}
        mid = P(mid)
        x = _resnet(mid["resnets"][0], x, temb, groups)
        if "attentions" in mid:
            x, scores = _spatial_transformer(
                mid["attentions"][0], x, ctx, cfg, cfg.mid_num_heads, "mid_block.attentions.0",
                False, use_flash, stash8_names,
            )
        x = _resnet(mid["resnets"][1], x, temb, groups)
        return x, scores

    x, _ = maybe_remat(mid_fn)(params["mid_block"], x, temb, ctx)

    n_levels = len(cfg.block_out_channels)
    for i in range(n_levels):
        level = n_levels - 1 - i
        bp = params["up_blocks"][i]
        has_attn = cfg.cross_attention[level]
        for j in range(cfg.layers_per_block + 1):
            layer_params = {"resnet": bp["resnets"][j]}
            if has_attn:
                layer_params["attention"] = bp["attentions"][j]

            def up_layer(layer_params, x, skip, temb, ctx, level=level, has_attn=has_attn,
                         name=f"up_blocks.{i}.attentions.{j}"):
                scores = {}
                layer_params = P(layer_params)
                x = torch.cat([x, skip], dim=-1)
                x = _resnet(layer_params["resnet"], x, temb, groups)
                if has_attn:
                    x, scores = _spatial_transformer(
                        layer_params["attention"], x, ctx, cfg, cfg.num_heads[level], name,
                        capture_attn, use_flash, stash8_names,
                    )
                return x, scores

            wrap = maybe_remat if has_attn else remat_plain
            x, scores = wrap(up_layer)(layer_params, x, skips.pop(), temb, ctx)
            attn_scores.update(scores)
        if "upsamplers" in bp:
            x = conv2d(P(bp["upsamplers"][0]["conv"]), upsample_nearest_2x(x), padding=1)

    x = conv2d(P(params["conv_out"]),
               group_norm(P(params["conv_norm_out"]), x, groups, silu=True), padding=1)
    return x, attn_scores


# ---------------------------------------------------------------------------
# Init (tests and the chip smoke run)
# ---------------------------------------------------------------------------


def init_unet_params(cfg: UNetConfig, generator: torch.Generator, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    """Random-init a UNet param tree with the structure conversion produces
    (the JAX package's init scales, torch layouts)."""

    def randn(*shape, std=0.02):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * std

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def lin(cin, cout):
        return {"weight": randn(cout, cin), "bias": zeros(cout)}

    def lin_nobias(cin, cout):
        return {"weight": randn(cout, cin)}

    def conv(cin, cout, k=3):
        return {"weight": randn(cout, cin, k, k), "bias": zeros(cout)}

    def norm(c):
        return {"weight": ones(c), "bias": zeros(c)}

    ted = cfg.time_embed_dim

    def resnet(cin, cout):
        p = {
            "norm1": norm(cin),
            "conv1": conv(cin, cout),
            "time_emb_proj": lin(ted, cout),
            "norm2": norm(cout),
            "conv2": conv(cout, cout),
        }
        if cin != cout:
            p["conv_shortcut"] = conv(cin, cout, 1)
        return p

    def tblock(c):
        return {
            "norm1": norm(c),
            "attn1": {
                "to_q": lin_nobias(c, c),
                "to_k": lin_nobias(c, c),
                "to_v": lin_nobias(c, c),
                "to_out.0": lin(c, c),
            },
            "norm2": norm(c),
            "attn2": {
                "to_q": lin_nobias(c, c),
                "to_k": lin_nobias(cfg.cross_attention_dim, c),
                "to_v": lin_nobias(cfg.cross_attention_dim, c),
                "to_out.0": lin(c, c),
            },
            "norm3": norm(c),
            "ff.net.0.proj": lin(c, c * 8),
            "ff.net.2": lin(c * 4, c),
        }

    def transformer(c, depth):
        p = {"norm": norm(c), "transformer_blocks": [tblock(c) for _ in range(depth)]}
        if cfg.use_linear_projection:
            p["proj_in"] = lin(c, c)
            p["proj_out"] = lin(c, c)
        else:
            p["proj_in"] = conv(c, c, 1)
            p["proj_out"] = conv(c, c, 1)
        return p

    ch = cfg.block_out_channels
    down_blocks = []
    cin = ch[0]
    for i, cout in enumerate(ch):
        block = {"resnets": []}
        if cfg.cross_attention[i]:
            block["attentions"] = []
        c = cin
        for _ in range(cfg.layers_per_block):
            block["resnets"].append(resnet(c, cout))
            if cfg.cross_attention[i]:
                block["attentions"].append(transformer(cout, cfg.transformer_layers[i]))
            c = cout
        if i < len(ch) - 1:
            block["downsamplers"] = [{"conv": conv(cout, cout)}]
        down_blocks.append(block)
        cin = cout

    mid_c = ch[-1]
    mid_block = {
        "resnets": [resnet(mid_c, mid_c), resnet(mid_c, mid_c)],
        "attentions": [transformer(mid_c, cfg.mid_transformer_layers)],
    }

    down_skip_channels = [ch[0]]
    for i, cout in enumerate(ch):
        down_skip_channels += [cout] * cfg.layers_per_block
        if i < len(ch) - 1:
            down_skip_channels.append(cout)

    up_blocks = []
    prev_out = mid_c
    for i, cout in enumerate(reversed(ch)):
        level = len(ch) - 1 - i
        block = {"resnets": []}
        if cfg.cross_attention[level]:
            block["attentions"] = []
        for _ in range(cfg.layers_per_block + 1):
            skip_c = down_skip_channels.pop()
            block["resnets"].append(resnet(prev_out + skip_c, cout))
            if cfg.cross_attention[level]:
                block["attentions"].append(transformer(cout, cfg.transformer_layers[level]))
            prev_out = cout
        if i < len(ch) - 1:
            block["upsamplers"] = [{"conv": conv(cout, cout)}]
        up_blocks.append(block)

    params = {
        "conv_in": conv(cfg.in_channels, ch[0]),
        "time_embedding": {"linear_1": lin(ch[0], ted), "linear_2": lin(ted, ted)},
        "down_blocks": down_blocks,
        "mid_block": mid_block,
        "up_blocks": up_blocks,
        "conv_norm_out": norm(ch[0]),
        "conv_out": conv(ch[0], cfg.out_channels),
    }
    if cfg.addition_embed_dim is not None:
        params["add_embedding"] = {
            "linear_1": lin(cfg.addition_input_dim, ted),
            "linear_2": lin(ted, ted),
        }
    return params
