"""The reference VAE decoder (diffusers' AutoencoderKL decoder, from
`vae/config.json`): post-quant conv, conv_in, the mid block (resnet,
single-head self-attention, resnet), the up blocks (resnets, then a
nearest 2x upsample and a conv), GroupNorm (eps 1e-6), SiLU, conv_out.
NCHW latents scaled by the SD factor in, images in [-1, 1] out."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.nn import Prec, conv, group_norm, heads, linear, merge, self_attention

_EPS = 1e-6


def _resnet(p, x, groups, prec):
    h = conv(p["conv1"], F.silu(group_norm(p["norm1"], x, groups, _EPS)), prec)
    h = conv(p["conv2"], F.silu(group_norm(p["norm2"], h, groups, _EPS)), prec)
    if "conv_shortcut" in p:
        x = conv(p["conv_shortcut"], x, prec, padding=0)
    return x + h


def _attention(p, x, groups, prec):
    b, c, hh, ww = x.shape
    h = group_norm(p["group_norm"], x, groups, _EPS).flatten(2).transpose(1, 2)
    q, k, v = (heads(linear(p[n], h, prec), 1) for n in ("to_q", "to_k", "to_v"))
    out = linear(p["to_out"], merge(self_attention(q, k, v, prec)), prec)
    return x + out.transpose(1, 2).reshape(b, c, hh, ww)


def decode(params: dict, z: torch.Tensor, vae: dict, prec: Prec) -> torch.Tensor:
    groups = vae["norm_num_groups"]
    dec = params["decoder"]
    x = conv(params["post_quant_conv"], (z / vae["scaling_factor"]).to(prec.dt), prec, padding=0)
    x = conv(dec["conv_in"], x, prec)
    mid = dec["mid_block"]
    x = _resnet(mid["resnets"][0], x, groups, prec)
    x = _attention(mid["attentions"][0], x, groups, prec)
    x = _resnet(mid["resnets"][1], x, groups, prec)
    for block in dec["up_blocks"]:
        for rp in block["resnets"]:
            x = _resnet(rp, x, groups, prec)
        if "upsamplers" in block:
            x = conv(block["upsamplers"][0]["conv"], F.interpolate(x, scale_factor=2.0,
                                                                   mode="nearest"), prec)
    x = F.silu(group_norm(dec["conv_norm_out"], x, groups, _EPS))
    return conv(dec["conv_out"], x, prec)
