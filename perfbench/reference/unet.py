"""The reference UNet2DConditionModel (SD1.5 and SDXL), from diffusers'
published architecture and the configuration file's keys (diffusers'
`unet/config.json` names). Parameters are the benchmark's tree in the
checkpoint's layout: linear [out, in], conv OIHW, nested by module path.

One departure from diffusers, noted in the configuration file under
`assumed`: the spatial transformers' GroupNorm takes `transformer_norm_eps`
(the system trains with 1e-5; diffusers hardcodes 1e-6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.nn import (
    Prec,
    conv,
    group_norm,
    heads,
    layer_norm,
    linear,
    merge,
    self_attention,
    softmax_attention,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetSpec:
    chans: Tuple[int, ...]
    cross: Tuple[bool, ...]
    layers: int
    depth: Tuple[int, ...]
    heads: Tuple[int, ...]
    cross_dim: int
    linear_proj: bool
    groups: int
    eps: float
    tf_eps: float
    in_ch: int
    out_ch: int
    time_ids_dim: Optional[int]  # SDXL's addition_time_embed_dim
    pooled_dim: Optional[int]

    @classmethod
    def from_config(cls, unet: dict, assumed: dict) -> "UNetSpec":
        n = len(unet["block_out_channels"])

        def per_level(v):
            return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n

        time_ids = pooled = None
        if unet.get("addition_embed_type") == "text_time":
            time_ids = unet["addition_time_embed_dim"]
            pooled = unet["projection_class_embeddings_input_dim"] - 6 * time_ids
        return cls(
            chans=tuple(unet["block_out_channels"]),
            cross=tuple(t.startswith("CrossAttn") for t in unet["down_block_types"]),
            layers=unet["layers_per_block"],
            depth=per_level(unet.get("transformer_layers_per_block", 1)),
            # diffusers' legacy name: attention_head_dim counts the heads here
            heads=per_level(unet["attention_head_dim"]),
            cross_dim=unet["cross_attention_dim"],
            linear_proj=bool(unet.get("use_linear_projection", False)),
            groups=unet["norm_num_groups"],
            eps=unet["norm_eps"],
            tf_eps=assumed["transformer_norm_eps"],
            in_ch=unet["in_channels"],
            out_ch=unet["out_channels"],
            time_ids_dim=time_ids,
            pooled_dim=pooled,
        )


class UNet:
    """`forward(x NCHW, t [B], ctx [B, 77, C], added) -> (eps NCHW, scores)`;
    `loras` maps a module path to {"a", "b", "scale"}; `scores` holds the
    head-summed scaled cross-attention logits [B, L, 77] (float32) of every
    down and up block when `capture`."""

    def __init__(self, params: dict, spec: UNetSpec, prec: Prec, loras: Dict[str, dict],
                 remat: bool = True):
        self.p, self.spec, self.prec, self.loras, self.remat = params, spec, prec, loras, remat

    def _lin(self, p, path, x):
        return linear(p, x, self.prec, self.loras.get(path))

    def _conv(self, p, path, x, stride=1, padding=1):
        return conv(p, x, self.prec, stride, padding, self.loras.get(path))

    def _resnet(self, p, path, x, temb):
        s = self.spec
        h = self._conv(p["conv1"], f"{path}.conv1", F.silu(group_norm(p["norm1"], x, s.groups, s.eps)))
        h = h + self._lin(p["time_emb_proj"], f"{path}.time_emb_proj", F.silu(temb))[:, :, None, None]
        h = self._conv(p["conv2"], f"{path}.conv2", F.silu(group_norm(p["norm2"], h, s.groups, s.eps)))
        if "conv_shortcut" in p:
            x = self._conv(p["conv_shortcut"], f"{path}.conv_shortcut", x, padding=0)
        return x + h

    def _block(self, p, path, x, ctx, n_heads, capture):
        prec = self.prec
        h = layer_norm(p["norm1"], x)
        a = p["attn1"]
        q, k, v = (heads(self._lin(a[n], f"{path}.attn1.{n}", h), n_heads)
                   for n in ("to_q", "to_k", "to_v"))
        x = x + self._lin(a["to_out.0"], f"{path}.attn1.to_out.0",
                          merge(self_attention(q, k, v, prec)))
        h = layer_norm(p["norm2"], x)
        a = p["attn2"]
        q = heads(self._lin(a["to_q"], f"{path}.attn2.to_q", h), n_heads)
        k = heads(self._lin(a["to_k"], f"{path}.attn2.to_k", ctx), n_heads)
        v = heads(self._lin(a["to_v"], f"{path}.attn2.to_v", ctx), n_heads)
        out, logits = softmax_attention(q, k, v, prec, want_logits=capture)
        x = x + self._lin(a["to_out.0"], f"{path}.attn2.to_out.0", merge(out))
        h = layer_norm(p["norm3"], x)
        value, gate = self._lin(p["ff.net.0.proj"], f"{path}.ff.net.0.proj", h).chunk(2, dim=-1)
        x = x + self._lin(p["ff.net.2"], f"{path}.ff.net.2", value * F.gelu(gate))
        return x, (logits.sum(dim=1) if capture else None)

    def _transformer(self, p, path, x, ctx, n_heads, capture):
        s = self.spec
        b, c, hh, ww = x.shape
        h = group_norm(p["norm"], x, s.groups, s.tf_eps)
        if s.linear_proj:
            h = self._lin(p["proj_in"], f"{path}.proj_in", h.flatten(2).transpose(1, 2))
        else:
            h = self._conv(p["proj_in"], f"{path}.proj_in", h, padding=0).flatten(2).transpose(1, 2)
        scores = {}
        for i, bp in enumerate(p["transformer_blocks"]):
            h, sc = self._block(bp, f"{path}.transformer_blocks.{i}", h, ctx, n_heads, capture)
            if sc is not None:
                scores[f"{path}.transformer_blocks.{i}.attn2"] = sc
        if s.linear_proj:
            h = self._lin(p["proj_out"], f"{path}.proj_out", h).transpose(1, 2).reshape(b, c, hh, ww)
        else:
            h = self._conv(p["proj_out"], f"{path}.proj_out",
                           h.transpose(1, 2).reshape(b, c, hh, ww), padding=0)
        return x + h, scores

    def _maybe_remat(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _temb(self, t, added):
        s, p, dt = self.spec, self.p, self.prec.dt
        te = p["time_embedding"]
        temb = self._lin(te["linear_2"], "time_embedding.linear_2", F.silu(
            self._lin(te["linear_1"], "time_embedding.linear_1",
                      timestep_embedding(t, s.chans[0]).to(dt))))
        if s.time_ids_dim is not None:
            ids = timestep_embedding(added["time_ids"].reshape(-1), s.time_ids_dim)
            ids = ids.reshape(t.shape[0], -1).to(dt)
            e = torch.cat([added["text_embeds"].to(dt), ids], dim=-1)
            ae = p["add_embedding"]
            temb = temb + self._lin(ae["linear_2"], "add_embedding.linear_2", F.silu(
                self._lin(ae["linear_1"], "add_embedding.linear_1", e)))
        return temb

    def forward(self, x, t, ctx, added=None, capture=False):
        s, p = self.spec, self.p
        x = x.to(self.prec.dt)
        ctx = ctx.to(self.prec.dt)
        temb = self._temb(t, added)
        x = self._conv(p["conv_in"], "conv_in", x)
        skips: List[torch.Tensor] = [x]
        scores: Dict[str, torch.Tensor] = {}
        for i, ch in enumerate(s.chans):
            bp = p["down_blocks"][i]
            for j in range(s.layers):
                path = f"down_blocks.{i}"

                def layer(x, temb, ctx, i=i, j=j, bp=bp, path=path):
                    x = self._resnet(bp["resnets"][j], f"{path}.resnets.{j}", x, temb)
                    if not s.cross[i]:
                        return x, {}
                    return self._transformer(bp["attentions"][j], f"{path}.attentions.{j}", x,
                                             ctx, s.heads[i], capture)

                x, sc = self._maybe_remat(layer, x, temb, ctx)
                scores.update(sc)
                skips.append(x)
            if "downsamplers" in bp:
                x = self._conv(bp["downsamplers"][0]["conv"], f"down_blocks.{i}.downsamplers.0.conv",
                               x, stride=2, padding=1)
                skips.append(x)

        def mid(x, temb, ctx):
            m = p["mid_block"]
            x = self._resnet(m["resnets"][0], "mid_block.resnets.0", x, temb)
            x, _ = self._transformer(m["attentions"][0], "mid_block.attentions.0", x, ctx,
                                     s.heads[-1], False)
            return self._resnet(m["resnets"][1], "mid_block.resnets.1", x, temb)

        x = self._maybe_remat(mid, x, temb, ctx)
        n = len(s.chans)
        for i in range(n):
            level = n - 1 - i
            bp = p["up_blocks"][i]
            for j in range(s.layers + 1):
                path = f"up_blocks.{i}"

                def layer(x, skip, temb, ctx, j=j, bp=bp, path=path, level=level):
                    x = self._resnet(bp["resnets"][j], f"{path}.resnets.{j}",
                                     torch.cat([x, skip], dim=1), temb)
                    if not s.cross[level]:
                        return x, {}
                    return self._transformer(bp["attentions"][j], f"{path}.attentions.{j}", x,
                                             ctx, s.heads[level], capture)

                x, sc = self._maybe_remat(layer, x, skips.pop(), temb, ctx)
                scores.update(sc)
            if "upsamplers" in bp:
                x = F.interpolate(x, scale_factor=2.0, mode="nearest")
                x = self._conv(bp["upsamplers"][0]["conv"], f"up_blocks.{i}.upsamplers.0.conv", x)
        x = F.silu(group_norm(p["conv_norm_out"], x, s.groups, s.eps))
        return self._conv(p["conv_out"], "conv_out", x), scores
