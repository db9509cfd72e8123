"""SD-style latent-diffusion UNet. Counterpart of ``repro/models/unet.py``.

The public layout is the reference's: latents NHWC ``(B, h, w, C)``, text
``(B, L, D)``. Inside, activations run NCHW and conv weights are OIHW;
``repro_torch.convert`` transposes the reference's HWIO weights. The
parameter tree and its names mirror ``init_unet``'s.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L


def _conv_init(mk, kh, kw, cin, cout):
    """OIHW: the reference's HWIO axes ("time", "time", "embed", "mlp")
    in this layout's order."""
    return {"w": mk((cout, cin, kh, kw), ("mlp", "embed", "time", "time"),
                    scale=1.0 / math.sqrt(kh * kw * cin)),
            "b": mk((cout,), ("mlp",), init="zeros")}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA "SAME": before = total // 2, after = the rest (stride 2 on an even
    size pads 0 before and 1 after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x, *, stride=1):
    """x NCHW, p.w OIHW, with XLA "SAME" padding."""
    w = p.w.to(x.dtype)
    kh, kw = w.shape[2:]
    ph, pw = _same_pads(x.shape[2], kh, stride), _same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(x, (*pw, *ph)), w, stride=stride)
    return y + p.b.to(x.dtype)[:, None, None]


def num_groups(channels: int, groups: int) -> int:
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def groupnorm(p, x, groups: int, eps=1e-5):
    """x NCHW; population variance in float32, returns x's dtype."""
    y = F.group_norm(x.float(), num_groups(x.shape[1], groups), eps=eps)
    return (y * p.scale.float()[:, None, None] + p.bias.float()[:, None, None]).to(x.dtype)


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


def _gn_init(mk, c):
    return {"scale": mk((c,), ("mlp",), init="ones"), "bias": mk((c,), ("mlp",), init="zeros")}


def init_resblock(mk, cin, cout, time_dim):
    p = {
        "gn1": _gn_init(mk, cin),
        "conv1": _conv_init(mk, 3, 3, cin, cout),
        "time_proj": {"w": mk((time_dim, cout), ("embed", "mlp"), scale=1 / math.sqrt(time_dim)),
                      "b": mk((cout,), ("mlp",), init="zeros")},
        "gn2": _gn_init(mk, cout),
        "conv2": _conv_init(mk, 3, 3, cout, cout),
    }
    if cin != cout:
        p["skip"] = _conv_init(mk, 1, 1, cin, cout)
    return p


def resblock(p, x, t_emb, groups):
    h = conv2d(p.conv1, _silu(groupnorm(p.gn1, x, groups)))
    t = F.silu(t_emb.float()).to(x.dtype) @ p.time_proj.w.to(x.dtype)
    h = h + (t + p.time_proj.b.to(x.dtype))[:, :, None, None]
    h = conv2d(p.conv2, _silu(groupnorm(p.gn2, h, groups)))
    skip = conv2d(p.skip, x) if hasattr(p, "skip") else x
    return skip + h


def init_attnblock(mk, c, text_dim):
    s = 1 / math.sqrt(c)
    return {
        "gn": _gn_init(mk, c),
        "self": {k: mk((c, c), ("heads", "embed") if k == "wo" else ("embed", "heads"), scale=s)
                 for k in ("wq", "wk", "wv", "wo")},
        "cross": {"wq": mk((c, c), ("embed", "heads"), scale=s),
                  "wk": mk((text_dim, c), ("embed", "heads"), scale=1 / math.sqrt(text_dim)),
                  "wv": mk((text_dim, c), ("embed", "heads"), scale=1 / math.sqrt(text_dim)),
                  "wo": mk((c, c), ("heads", "embed"), scale=s)},
    }


def _mha(p, q_in, kv_in, heads):
    """Plain matmul + softmax, as the reference writes it. A bf16 text
    context meets float32 weights: jnp promotes the product to float32, so
    the context is cast to the query's dtype first."""
    B, Nq, C = q_in.shape
    hd = C // heads
    kv_in = kv_in.to(q_in.dtype)
    q = (q_in @ p.wq.to(q_in.dtype)).reshape(B, Nq, heads, hd).transpose(1, 2)
    k = (kv_in @ p.wk.to(q_in.dtype)).reshape(B, -1, heads, hd).transpose(1, 2)
    v = (kv_in @ p.wv.to(q_in.dtype)).reshape(B, -1, heads, hd).transpose(1, 2)
    s = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
    w = torch.softmax(s, dim=-1).to(q_in.dtype)
    o = (w @ v).transpose(1, 2).reshape(B, Nq, C)
    return o @ p.wo.to(q_in.dtype)


def attnblock(p, x, text, heads, groups):
    B, C, H, W = x.shape
    h = groupnorm(p.gn, x, groups).reshape(B, C, H * W).transpose(1, 2)
    h = h + _mha(p.get_submodule("self"), h, h, heads)
    h = h + _mha(p.cross, h, text, heads)
    return x + h.transpose(1, 2).reshape(B, C, H, W)


def init_unet(cfg, mk):
    """The parameter tree of ``repro.models.unet.init_unet``, conv weights OIHW."""
    ch = [cfg.base_channels * m for m in cfg.channel_mults]
    td = cfg.time_dim
    p = {
        "time_mlp": {
            "w1": mk((cfg.base_channels, td), ("embed", "mlp"),
                     scale=1 / math.sqrt(cfg.base_channels)),
            "b1": mk((td,), ("mlp",), init="zeros"),
            "w2": mk((td, td), ("mlp", "mlp"), scale=1 / math.sqrt(td)),
            "b2": mk((td,), ("mlp",), init="zeros"),
        },
        "conv_in": _conv_init(mk, 3, 3, cfg.in_channels, ch[0]),
        "down": [], "up": [],
    }
    skips = [ch[0]]
    cin = ch[0]
    for lvl, c in enumerate(ch):
        lp = {"res": [], "attn": []}
        for _ in range(cfg.num_res_blocks):
            lp["res"].append(init_resblock(mk, cin, c, td))
            lp["attn"].append(init_attnblock(mk, c, cfg.text_dim)
                              if 2 ** lvl in cfg.attn_resolutions else None)
            cin = c
            skips.append(c)
        if lvl < len(ch) - 1:
            lp["downsample"] = _conv_init(mk, 3, 3, c, c)
            skips.append(c)
        p["down"].append(lp)
    p["mid1"] = init_resblock(mk, cin, cin, td)
    p["mid_attn"] = init_attnblock(mk, cin, cfg.text_dim)
    p["mid2"] = init_resblock(mk, cin, cin, td)
    for lvl, c in reversed(list(enumerate(ch))):
        lp = {"res": [], "attn": []}
        for _ in range(cfg.num_res_blocks + 1):
            sk = skips.pop()
            lp["res"].append(init_resblock(mk, cin + sk, c, td))
            lp["attn"].append(init_attnblock(mk, c, cfg.text_dim)
                              if 2 ** lvl in cfg.attn_resolutions else None)
            cin = c
        if lvl > 0:
            lp["upsample"] = _conv_init(mk, 3, 3, c, c)
        p["up"].append(lp)
    p["gn_out"] = _gn_init(mk, cin)
    p["conv_out"] = _conv_init(mk, 3, 3, cin, cfg.out_channels)
    return p


class UNet(nn.Module):
    """The denoiser: ``(x (B,h,w,Cin) NHWC, t (B,), text (B,L,D)) -> eps``
    NHWC. Parameters are created frozen; ``repro_torch.train.diffusion``
    trains them after ``requires_grad_(True)``, and the samplers run under
    ``torch.no_grad()``."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        self.cfg = cfg
        for name, sub in tree.items():
            self.add_module(name, L.tree_module(sub))

    @classmethod
    def init(cls, cfg, generator=None, *, dtype=torch.float32, device=None):
        """Random weights at ``init_unet``'s scales, drawn from ``generator``
        on ``device`` (``None``: the GPU)."""
        return cls(cfg, init_unet(cfg, L.Maker(generator, dtype, resolve_device(device))))

    @classmethod
    def from_state_dict(cls, cfg, state: dict):
        """A UNet holding ``state``'s tensors as they are (dtype and device)."""
        skeleton = cls(cfg, init_unet(cfg, L.SpecMaker(torch.float32)))
        skeleton.load_state_dict(state, assign=True)
        return skeleton

    def forward(self, x, t, text):
        cfg, g = self.cfg, self.cfg.norm_groups
        te = L.sinusoidal_embedding(t, cfg.base_channels)
        tm = self.time_mlp
        te = F.silu(te @ tm.w1.to(te.dtype) + tm.b1.to(te.dtype))
        te = te @ tm.w2.to(te.dtype) + tm.b2.to(te.dtype)

        h = conv2d(self.conv_in, x.permute(0, 3, 1, 2).contiguous())
        skips = [h]
        n_lvls = len(cfg.channel_mults)
        for lvl, lp in enumerate(self.down):
            for rp, ap in zip(lp.res, lp.attn):
                h = resblock(rp, h, te, g)
                if ap is not None:
                    h = attnblock(ap, h, text, cfg.num_heads, g)
                skips.append(h)
            if lvl < n_lvls - 1:
                h = conv2d(lp.downsample, h, stride=2)
                skips.append(h)
        h = resblock(self.mid1, h, te, g)
        h = attnblock(self.mid_attn, h, text, cfg.num_heads, g)
        h = resblock(self.mid2, h, te, g)
        for i, lp in enumerate(self.up):
            lvl = n_lvls - 1 - i
            for rp, ap in zip(lp.res, lp.attn):
                h = resblock(rp, torch.cat([h, skips.pop()], dim=1), te, g)
                if ap is not None:
                    h = attnblock(ap, h, text, cfg.num_heads, g)
            if lvl > 0:
                h = conv2d(lp.upsample, F.interpolate(h, scale_factor=2, mode="nearest"))
        h = _silu(groupnorm(self.gn_out, h, g))
        return conv2d(self.conv_out, h).permute(0, 2, 3, 1).contiguous()


def unet_forward(unet: UNet, x, t, text):
    """x (B,h,w,Cin) latents, t (B,) timesteps, text (B,L,text_dim)."""
    return unet(x, t, text)
