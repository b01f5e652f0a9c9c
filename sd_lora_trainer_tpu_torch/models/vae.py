"""AutoencoderKL (the SD VAE) over parameter dicts, NHWC.

Counterpart of sd_lora_trainer_tpu/models/vae.py. The encoder caches each
training image's latent distribution (mean, logvar) once
(data/dataset.py); the decoder turns validation renders back into images
(inference.py). Latents are NHWC [B, H/8, W/8, 4].

The tree keeps the JAX package's diffusers-style module paths with the
checkpoint's torch layouts (conv OIHW, norm "weight"); the mid-block
attention's 1x1 convs q, k, v, proj_out are linears (out, in). That
attention has one head of the block's full width (512) and runs the plain
`ops/attention.py::multihead_attention`, as the JAX package runs its plain
einsum attention there: no flash path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from sd_lora_trainer_tpu_torch.models.layers import conv2d, dense, group_norm, upsample_nearest_2x
from sd_lora_trainer_tpu_torch.ops.attention import multihead_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215  # 0.13025 for the SDXL VAE
    sample_channels: int = 3


SD15_VAE_CONFIG = VAEConfig(scaling_factor=0.18215)
SDXL_VAE_CONFIG = VAEConfig(scaling_factor=0.13025)


def downsample_factor(cfg: VAEConfig) -> int:
    """Image pixels per latent pixel along one side (8 for SD)."""
    return 2 ** (len(cfg.block_out_channels) - 1)


def _resnet(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv2d(p["conv1"], group_norm(p["norm1"], x, groups, eps=1e-6, silu=True), padding=1)
    h = conv2d(p["conv2"], group_norm(p["norm2"], h, groups, eps=1e-6, silu=True), padding=1)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding="VALID")
    return x + h


def _attn_block(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Single-head spatial self-attention (the VAE mid-block attention)."""
    b, h, w, c = x.shape
    hidden = group_norm(p["group_norm"], x, groups, eps=1e-6).reshape(b, h * w, c)
    q, k, v = (dense(p[name], hidden) for name in ("to_q", "to_k", "to_v"))
    out, _ = multihead_attention(q, k, v, heads=1)
    return x + dense(p["to_out"], out).reshape(b, h, w, c)


def vae_encode(params: dict, images: torch.Tensor, cfg: VAEConfig = SD15_VAE_CONFIG):
    """images NHWC in [-1, 1] -> (mean, logvar), each [B, H/8, W/8, 4]."""
    enc = params["encoder"]
    g = cfg.norm_num_groups
    x = conv2d(enc["conv_in"], images, padding=1)
    for block in enc["down_blocks"]:
        for rp in block["resnets"]:
            x = _resnet(rp, x, g)
        if "downsamplers" in block:
            # diffusers pads (0, 1) x (0, 1), then a stride-2 VALID conv
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
            x = conv2d(block["downsamplers"][0]["conv"], x, stride=2, padding="VALID")
    mid = enc["mid_block"]
    x = _resnet(mid["resnets"][0], x, g)
    x = _attn_block(mid["attentions"][0], x, g)
    x = _resnet(mid["resnets"][1], x, g)
    x = conv2d(enc["conv_out"], group_norm(enc["conv_norm_out"], x, g, eps=1e-6, silu=True),
               padding=1)
    moments = conv2d(params["quant_conv"], x, padding="VALID")
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_sample(mean: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor,
               scaling_factor: float) -> torch.Tensor:
    """A latent drawn from the cached distribution with the explicit normal
    draw `eps`, times the SD scale (JAX draws eps from a key)."""
    return (mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)) * scaling_factor


def vae_decode(params: dict, latents: torch.Tensor, cfg: VAEConfig = SD15_VAE_CONFIG):
    """Scaled latents [B, h, w, 4] -> images NHWC in [-1, 1]."""
    dec = params["decoder"]
    g = cfg.norm_num_groups
    z = latents / cfg.scaling_factor
    z = conv2d(params["post_quant_conv"], z, padding="VALID")
    x = conv2d(dec["conv_in"], z, padding=1)
    mid = dec["mid_block"]
    x = _resnet(mid["resnets"][0], x, g)
    x = _attn_block(mid["attentions"][0], x, g)
    x = _resnet(mid["resnets"][1], x, g)
    for block in dec["up_blocks"]:
        for rp in block["resnets"]:
            x = _resnet(rp, x, g)
        if "upsamplers" in block:
            x = conv2d(block["upsamplers"][0]["conv"], upsample_nearest_2x(x), padding=1)
    return conv2d(dec["conv_out"], group_norm(dec["conv_norm_out"], x, g, eps=1e-6, silu=True),
                  padding=1)


def vae_decode_batched(params: dict, latents: torch.Tensor, cfg: VAEConfig = SD15_VAE_CONFIG,
                       max_latent_px: int = 128 * 128) -> torch.Tensor:
    """Decode in batch chunks of at most `max_latent_px` latent pixels each
    (one 1024px image by default): the same images as one plain decode at a
    bounded activation size. A single image above the budget goes to
    `vae_decode_tiled`. The JAX package maps over the chunks with `lax.map`;
    here a loop does."""
    b, H, W, _ = latents.shape
    if H * W > max_latent_px:
        return vae_decode_tiled(params, latents, cfg, max_latent_px=max_latent_px)
    per = max(int(max_latent_px // (H * W)), 1)
    if per >= b:
        return vae_decode(params, latents, cfg)
    return torch.cat([vae_decode(params, latents[i:i + per], cfg) for i in range(0, b, per)])


def _taper(length: int, overlap: int, device=None) -> torch.Tensor:
    """[length] blend weights: a linear ramp over `overlap` px at both ends
    (adjacent tiles' ramps sum to 1 across their overlap)."""
    ramp = torch.arange(1, overlap + 1, dtype=torch.float32, device=device) / (overlap + 1)
    mid = torch.ones(length - 2 * overlap, dtype=torch.float32, device=device)
    return torch.cat([ramp, mid, ramp.flip(0)])


def _tile_plan(n: int, tile: int, overlap: int) -> Tuple[int, List[int]]:
    """(tile size, positions): the fewest tiles covering `n` latent px with
    >= `overlap` px of overlap, spread evenly, sizes a multiple of 8."""
    if n <= tile:
        return n, [0]
    count = -(-(n - overlap) // (tile - overlap))
    t = -(-(n + (count - 1) * overlap) // count)
    t = min(-(-t // 8) * 8, n)
    if t >= n:
        return n, [0]
    return t, [round(i * (n - t) / (count - 1)) for i in range(count)]


def vae_decode_tiled(params: dict, latents: torch.Tensor, cfg: VAEConfig = SD15_VAE_CONFIG,
                     tile: int = 80, overlap: int = 16,
                     max_latent_px: int = 128 * 128) -> torch.Tensor:
    """Decode overlapping latent tiles of at most `tile` px a side and blend
    them with linear ramps, normalized by the summed weights; each decode
    call sees at most `max_latent_px` latent pixels (the batch is chunked
    too). Seams differ from the untiled decode only where receptive fields
    cross tile borders."""
    b, H, W, _ = latents.shape
    if H <= tile and W <= tile:
        return vae_decode(params, latents, cfg)
    th, ys = _tile_plan(H, tile, overlap)
    tw, xs = _tile_plan(W, tile, overlap)
    if (th, tw) == (H, W):
        return vae_decode(params, latents, cfg)
    per = max(min(int(max_latent_px // (th * tw)), b), 1)
    f = downsample_factor(cfg)
    ov_h = min([th] + [ys[i] + th - ys[i + 1] for i in range(len(ys) - 1)])
    ov_w = min([tw] + [xs[i] + tw - xs[i + 1] for i in range(len(xs) - 1)])
    dev = latents.device
    w2 = (_taper(th * f, max(ov_h // 2, 1) * f, dev)[:, None]
          * _taper(tw * f, max(ov_w // 2, 1) * f, dev)[None, :])
    canvas = torch.zeros(b, H * f, W * f, cfg.sample_channels, dtype=torch.float32, device=dev)
    wsum = torch.zeros(H * f, W * f, dtype=torch.float32, device=dev)
    for y in ys:
        for x in xs:
            tile_z = latents[:, y:y + th, x:x + tw]
            decoded = torch.cat([vae_decode(params, tile_z[c:c + per], cfg)
                                 for c in range(0, b, per)])
            canvas[:, y * f:(y + th) * f, x * f:(x + tw) * f] += (
                decoded.float() * w2[None, :, :, None])
            wsum[y * f:(y + th) * f, x * f:(x + tw) * f] += w2
    return (canvas / wsum[None, :, :, None]).to(latents.dtype)


# ---------------------------------------------------------------------------
# Random init (tests and synthetic checkpoints)
# ---------------------------------------------------------------------------


def init_vae_params(cfg: VAEConfig, generator: torch.Generator, dtype=torch.float32,
                    device="cuda") -> dict:
    """Random-init a VAE tree with the structure conversion produces (the
    JAX package's init scales, torch layouts)."""

    def conv(cin, cout, k=3):
        w = torch.randn(cout, cin, k, k, generator=generator, device=device) * 0.02
        return {"weight": w.to(dtype), "bias": torch.zeros(cout, dtype=dtype, device=device)}

    def gn(c):
        return {"weight": torch.ones(c, dtype=dtype, device=device),
                "bias": torch.zeros(c, dtype=dtype, device=device)}

    def lin(cin, cout):
        w = torch.randn(cout, cin, generator=generator, device=device) * 0.02
        return {"weight": w.to(dtype), "bias": torch.zeros(cout, dtype=dtype, device=device)}

    def resnet(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(cin, cout), "norm2": gn(cout),
             "conv2": conv(cout, cout)}
        if cin != cout:
            p["conv_shortcut"] = conv(cin, cout, 1)
        return p

    def attn(c):
        return {"group_norm": gn(c), "to_q": lin(c, c), "to_k": lin(c, c), "to_v": lin(c, c),
                "to_out": lin(c, c)}

    ch = cfg.block_out_channels
    down_blocks = []
    cin = ch[0]
    for i, cout in enumerate(ch):
        block = {"resnets": [resnet(cin if j == 0 else cout, cout)
                             for j in range(cfg.layers_per_block)]}
        if i < len(ch) - 1:
            block["downsamplers"] = [{"conv": conv(cout, cout)}]
        down_blocks.append(block)
        cin = cout
    encoder = {
        "conv_in": conv(cfg.sample_channels, ch[0]),
        "down_blocks": down_blocks,
        "mid_block": {"resnets": [resnet(ch[-1], ch[-1]), resnet(ch[-1], ch[-1])],
                      "attentions": [attn(ch[-1])]},
        "conv_norm_out": gn(ch[-1]),
        "conv_out": conv(ch[-1], 2 * cfg.latent_channels),
    }
    rev = list(reversed(ch))
    up_blocks = []
    cin = rev[0]
    for i, cout in enumerate(rev):
        block = {"resnets": [resnet(cin if j == 0 else cout, cout)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(rev) - 1:
            block["upsamplers"] = [{"conv": conv(cout, cout)}]
        up_blocks.append(block)
        cin = cout
    decoder = {
        "conv_in": conv(cfg.latent_channels, rev[0]),
        "mid_block": {"resnets": [resnet(rev[0], rev[0]), resnet(rev[0], rev[0])],
                      "attentions": [attn(rev[0])]},
        "up_blocks": up_blocks,
        "conv_norm_out": gn(rev[-1]),
        "conv_out": conv(rev[-1], cfg.sample_channels),
    }
    return {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1),
        "post_quant_conv": conv(cfg.latent_channels, cfg.latent_channels, 1),
    }
