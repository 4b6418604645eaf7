"""Plain PyTorch reference of the BEVRender model and of one training step.

Everything is float32 on NHWC tensors, with TF32 off (``tf32_off``): the
backbone (ResNet-18 without FPN), the learned BEV query, the history passes
in eval semantics without gradient, the final pass, the seven encoder
stages of two layers (depthwise 3x3, temporal self-attention, conv MLP,
depthwise 3x3, spatial cross-attention, conv MLP, each branch after one
shared LayerNorm and, in training, drop path), the pyramid's transitions
and width fixes, and the render decoder. An attention site is

    bias[n, m] = bilinear(table, ((Ht - 1) / 4) (q_pos[m] - k_pos[n]) + centre)
    out[m]     = sum_n softmax_n(scale k[n] . q[m] + bias[n, m]) v[n]

with the lookup's window starts clipped to the table zero-padded by PAD
(a key displaced past the pad reads the clipped window, as the model
defines it), computed whole here in blocks of rows. The training step is
the MSE render loss, its gradient, the global-norm clip and AdamW.

``site_bf16=True`` rounds the operands of each attention site (the rpe
table, q, k, the softmax's p and v) to bfloat16, where the program's site
kernels and its plain consumer round them (the gradient passes straight
through the rounding): a diagnostic of how far that rounding alone moves
the first steps, never used to decide ``correct``.

Parameters and buffers are a dict of tensors keyed by the model's state
names, made by the caller from the seed. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.geometry import align_history, sample_nhwc, view_points

PAD = 4  # zero rows and columns around an rpe table
# bytes a block of site rows may hold in its larger temporaries
SITE_BLOCK_BYTES = 768 << 20


@contextlib.contextmanager
def tf32_off():
    """IEEE float32 products and convolutions while inside."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _bf16(x: torch.Tensor) -> torch.Tensor:
    d = x.detach()
    return x + (d.to(torch.bfloat16).float() - d)


def mask_seed(*ints: int) -> int:
    """The dropout seed of a training step from (epoch key, step), as the
    trainer derives it (a 63-bit word of numpy's SeedSequence)."""
    return int(np.random.SeedSequence([int(i) for i in ints]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Reference:
    """The model of ``m`` (a config's ``model`` section) over the state
    ``w`` (name -> tensor, parameters and BatchNorm buffers)."""

    def __init__(self, m: dict, w: dict, site_bf16: bool = False,
                 remat: bool = True):
        self.m, self.w, self.site_bf16, self.remat = m, w, site_bf16, remat
        dev = next(iter(w.values())).device
        self.ref_pts = [torch.from_numpy(view_points(m, b)).to(dev)
                        for b in m["bev_shapes"][:m["n_stages"]]]
        self.training = False
        self.calibrating = False  # eval BatchNorm takes batch statistics
        self.gen = None

    # -- basic layers ------------------------------------------------------
    def q(self, x):
        return _bf16(x) if self.site_bf16 else x

    def conv(self, x, name, stride=1, padding=0, groups=1):
        w, b = self.w[name + ".weight"], self.w.get(name + ".bias")
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, padding, 1, groups)
        return y.permute(0, 2, 3, 1)

    def dense(self, x, name):
        return F.linear(x, self.w[name + ".weight"], self.w[name + ".bias"])

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".weight"],
                            self.w[name + ".bias"], 1e-6)

    def bn(self, x, name):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        rm, rv = self.w[name + ".running_mean"], self.w[name + ".running_var"]
        if self.calibrating:
            mean = x.mean(dim=(0, 1, 2))
            rm.copy_(mean)
            rv.copy_(torch.clamp((x * x).mean(dim=(0, 1, 2)) - mean * mean,
                                 min=0.0))
        if not self.training:
            return (x - rm) * torch.rsqrt(rv + 1e-5) * w + b
        mean = x.mean(dim=(0, 1, 2))
        var = torch.clamp((x * x).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
        with torch.no_grad():
            rm.lerp_(mean, 0.1)
            rv.lerp_(var, 0.1)
        return (x - mean) * torch.rsqrt(var + 1e-5) * w + b

    @staticmethod
    def gelu(x):
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                           * (x + 0.044715 * x ** 3)))

    def drop_path(self, x):
        rate = self.m["drop_path_rate"]
        if not self.training or rate == 0.0:
            return x
        keep = 1.0 - rate
        r = torch.rand((x.shape[0], 1, 1, 1), generator=self.gen,
                       device=x.device)
        return torch.where(r < keep, x / keep, torch.zeros_like(x))

    # -- backbone ----------------------------------------------------------
    def backbone(self, x):
        p = "encoder.img_backbone.resnet."
        x = F.relu(self.bn(self.conv(x, p + "stem_conv", 2, 1), p + "stem_bn"))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        strides = (1, 2, 1, 1) if self.m["bev_shapes"][0] == 28 else (1, 1, 1, 1)
        for si, s in enumerate(strides):
            for bi in range(2):
                b = f"{p}layer{si + 2}_block{bi}."
                st = s if bi == 0 else 1
                y = F.relu(self.bn(self.conv(x, b + "conv1", st, 1), b + "bn1"))
                y = self.bn(self.conv(y, b + "conv2", 1, 1), b + "bn2")
                if b + "down_conv.weight" in self.w:
                    x = self.bn(self.conv(x, b + "down_conv", st), b + "down_bn")
                x = F.relu(y + x)
        return x

    # -- attention sites ---------------------------------------------------
    def lattice_bias(self, table, kpos, H, W):
        """table (G, Hpg, 2H - 1, Wt); kpos (R, G, N, 2) (y, x) -> bias
        (R, G, Hpg, N, H * W)."""
        G, Hpg, Ht, Wt = table.shape
        R, _, N, _ = kpos.shape
        ay, ax = (Ht - 1) / 4.0, (Wt - 1) / 4.0
        m_max = -(-(Wt - 1) // 2) + 3 + PAD
        xp, yp = Wt + PAD + max(PAD, m_max), Ht + 2 * PAD
        sy = -ay * kpos[..., 0] + (Ht - 1) / 2.0 - (H - 1) / 2.0
        sx = -ax * kpos[..., 1] + (Wt - 1) / 2.0 - ax
        y0, x0 = torch.floor(sy), torch.floor(sx)
        wy, f = sy - y0, sx - x0
        ys = torch.clamp(y0.long() + PAD, 0, yp - (H + 1))
        ms = torch.clamp(x0.long() + PAD, 0, m_max - 3)
        shift = ax * (-1.0 + 2.0 * np.arange(W) / (W - 1)) + ax
        u0 = np.floor(shift)
        u0_t = torch.tensor(u0, dtype=torch.long, device=kpos.device)
        g_t = torch.tensor((shift - u0).astype(np.float32), device=kpos.device)
        phi = g_t + f[..., None]                      # (R, G, N, W)
        cross = torch.floor(phi)
        wx = (phi - cross)[:, :, :, None, :, None]
        c0 = u0_t + ms[..., None] + cross.long()      # (R, G, N, W)
        rows = ys[..., None] + torch.arange(H + 1, device=kpos.device)
        gi = torch.arange(G, device=kpos.device)[None, :, None, None]
        idx = (((gi * yp + rows) * xp)[..., None]
               + c0[:, :, :, None, :])                # (R, G, N, H + 1, W)
        tp = F.pad(self.q(table), (PAD, xp - Wt - PAD, PAD, PAD))
        flat = tp.permute(0, 2, 3, 1).reshape(-1, Hpg)
        v0, v1 = flat[idx], flat[idx + 1]             # (R, G, N, H+1, W, Hpg)
        xl = v0 + wx * (v1 - v0)
        wyb = wy[:, :, :, None, None, None]
        bias = xl[:, :, :, :H] + wyb * (xl[:, :, :, 1:] - xl[:, :, :, :H])
        return bias.permute(0, 1, 5, 2, 3, 4).reshape(R, G, Hpg, N, H * W)

    def _site_rows(self, q, k, v, kpos, table, H, W, scale):
        bias = self.lattice_bias(table, kpos, H, W)
        s = torch.einsum("rghnc,rghmc->rghnm", self.q(k), self.q(q))
        p = torch.softmax(s * scale + bias, dim=-2)
        return torch.einsum("rghnm,rghnc->rghmc", self.q(p), self.q(v))

    def site(self, q, k, v, kpos, table, H, W, scale):
        """q (R, G, Hpg, M, ch), k, v (R, G, Hpg, N, ch) -> (R, G, Hpg, M,
        ch), in blocks of rows (each recomputed in the backward)."""
        R, G, Hpg, M, _ = q.shape
        N = k.shape[3]
        per_row = G * Hpg * N * (M + 2 * (H + 1) * (M // H + 1)) * 4 * 3
        step = max(1, min(R, SITE_BLOCK_BYTES // max(per_row, 1)))
        outs = []
        for r0 in range(0, R, step):
            part = (q[r0:r0 + step], k[r0:r0 + step], v[r0:r0 + step],
                    kpos[r0:r0 + step], table)
            fn = lambda *t: self._site_rows(*t, H, W, scale)  # noqa: E731
            if self.remat and torch.is_grad_enabled():
                outs.append(checkpoint(fn, *part, use_reentrant=False))
            else:
                outs.append(fn(*part))
        return torch.cat(outs)

    @staticmethod
    def heads(x, G, Hpg):
        B, M, C = x.shape
        return x.reshape(B, M, G, Hpg, C // (G * Hpg)).permute(0, 2, 3, 1, 4)

    @staticmethod
    def unheads(x):
        B, G, Hpg, M, ch = x.shape
        return x.permute(0, 3, 1, 2, 4).reshape(B, M, G * Hpg * ch)

    @staticmethod
    def grouped(x, G):
        B, H, W, C = x.shape
        return x.reshape(B, H, W, G, C // G).permute(0, 3, 1, 2, 4).reshape(
            B * G, H, W, C // G)

    def sampled_kv(self, p, feat, pos, G):
        """K and V of keys at pos (n, G, N, 2) (y, x) in feat (n, h, w, C)."""
        n, _, _, C = feat.shape
        N = pos.shape[2]
        kv = sample_nhwc(self.grouped(feat, G), pos.reshape(n * G, N, 2).flip(-1))
        kv = kv.reshape(n, G, N, C // G).permute(0, 2, 1, 3).reshape(n, N, C)
        return self.dense(kv, p + "proj_k"), self.dense(kv, p + "proj_v")

    def tsa(self, p, query, prev, s):
        m = self.m
        B, H, W, C = query.shape
        G, nh = m["n_groups"][s], m["n_heads"][s]
        Hpg, ch = nh // G, C // nh
        k_s, st = m["kernel_sizes"][s], m["strides"][s]
        pad = k_s // 2 if k_s != st else 0
        off = self.conv(self.grouped(query, G), p + "offset_dwconv", st, pad,
                        groups=C // G)
        off = self.conv(self.gelu(self.ln(off, p + "offset_norm")),
                        p + "offset_proj")
        hk, wk = off.shape[1], off.shape[2]
        ys = torch.linspace(-1.0, 1.0, hk, device=off.device)
        xs = torch.linspace(-1.0, 1.0, wk, device=off.device)
        ref = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1)
        rng = torch.tensor([1.0 / (hk - 1.0), 1.0 / (wk - 1.0)], device=off.device)
        pos = torch.tanh(off) * rng * 0.5 + ref[None]
        k, v = self.sampled_kv(p, query if prev is None else prev,
                               pos.reshape(B, G, hk * wk, 2), G)
        table = self.w[p + "rpe_table"].reshape(G, Hpg, 2 * H - 1, 2 * W - 1)
        out = self.site(self.heads(query.reshape(B, H * W, C), G, Hpg),
                        self.heads(k, G, Hpg), self.heads(v, G, Hpg),
                        pos.reshape(B, G, hk * wk, 2), table, H, W, ch ** -0.5)
        return self.dense(self.unheads(out).reshape(B, H, W, C), p + "proj_out")

    def sca(self, p, query, feat, s):
        m = self.m
        B, H, W, C = query.shape
        G, nh, d, V = m["n_groups"][s], m["n_heads"][s], m["bev_depth_dim"], m["num_views"]
        Hpg, ch = nh // G, C // nh
        qg = self.grouped(query, G)
        q5 = self.heads(query.reshape(B, H * W, C), G, Hpg)
        table = self.w[p + "rpe_table"].reshape(G, Hpg, 2 * H - 1, 2 * W * d - 1)
        outs = []
        for view in range(V):
            ref = self.ref_pts[s][view]              # (h2, W * d, 2) (x, y)
            h2 = ref.shape[0]
            off = self.conv(qg, f"{p}offset_expand_m{view}", groups=C // G)
            off = self.gelu(self.ln(off, f"{p}offset_norm_m{view}"))
            if H % 2:
                off = F.pad(off, (0, 0, 0, 0, 0, 1))
            off = self.conv(off, f"{p}offset_proj_m{view}", (2, 1))[:, :h2]
            off = off.reshape(B * G, h2, W * d, 2)
            rng = torch.tensor([1.0 / (h2 - 1.0), 1.0 / (W * d - 1.0)],
                               device=off.device)
            pos = (torch.tanh(off) * rng * 5.0 + ref.flip(-1)[None]).reshape(
                B, G, h2 * W * d, 2)
            k, v = self.sampled_kv(p, feat[:, view], pos, G)
            o = self.site(q5, self.heads(k, G, Hpg), self.heads(v, G, Hpg),
                          pos, table, H, W, ch ** -0.5)
            outs.append(self.unheads(o).reshape(B, H, W, C))
        return self.dense(torch.cat(outs, -1), p + "proj_out")

    def mlp(self, x, p):
        x = self.conv(x, p + "linear1")
        x = x + self.conv(x, p + "dwc", 1, 1, groups=x.shape[-1])
        return self.conv(self.gelu(x), p + "linear2")

    def layer(self, p, x, feat, prev, s):
        ln = lambda t: self.ln(t, p + "layer_norm")  # noqa: E731
        dp = self.drop_path
        x = x + self.conv(x, p + "tsa_lpu", 1, 1, groups=x.shape[-1])
        x = dp(self.tsa(p + "temporal_self_attn.", ln(x), prev, s)) + x
        x = dp(self.mlp(ln(x), p + "tsa_mlp.")) + x
        x = x + self.conv(x, p + "sca_lpu", 1, 1, groups=x.shape[-1])
        x = dp(self.sca(p + "spatial_cross_attn.", ln(x), feat, s)) + x
        return dp(self.mlp(ln(x), p + "sca_mlp.")) + x

    def encoder(self, query, images, prev, pose_pair, align):
        m = self.m
        B, V = images.shape[:2]
        feat = self.backbone(images.reshape((B * V,) + images.shape[2:]))
        feat = feat.reshape((B, V) + feat.shape[1:])
        if prev is not None and align:
            prev = align_history(prev, pose_pair)
        x = query
        bev, dims = m["bev_shapes"], m["embed_dims"]
        for s in range(m["n_stages"]):
            fix = f"encoder.img_width_fix{s}"
            f_s = self.dense(feat, fix) if fix + ".weight" in self.w else feat
            hist = prev if (bev[s] == bev[0] and dims[s] == dims[0]) else None
            for i in range(m["depths"][s]):
                x = self.layer(f"encoder.stage{s}.layers.{i}.", x, f_s, hist, s)
            t = f"encoder.stage{s}.transition"
            if t + ".weight" in self.w:
                if bev[s] > bev[s + 1]:
                    x = self.conv(x, t, 2, 1)
                elif bev[s] < bev[s + 1]:
                    y = F.conv_transpose2d(
                        x.permute(0, 3, 1, 2), self.w[t + ".weight"],
                        self.w[t + ".bias"], stride=2)
                    x = y.permute(0, 2, 3, 1)
                else:
                    x = self.conv(x, t)
        return x

    # -- decoder -----------------------------------------------------------
    def decoder(self, x):
        p = "decoder."
        x = F.relu(self.bn(self.conv(x, p + "stem_conv", 2, 3), p + "stem_bn"))
        for blk in ("block1", "block2", "block3"):
            for i in range(4):
                x = self.bn(self.conv(x, f"{p}{blk}.conv{i}", 1, 1),
                            f"{p}{blk}.bn{i}")
            x = F.relu(x)
        i = 0
        while f"{p}up{i}.conv0.weight" in self.w:
            x = self.bn(self.conv(self.up2(x), f"{p}up{i}.conv0", 1, 1),
                        f"{p}up{i}.bn0")
            x = F.relu(self.bn(self.conv(x, f"{p}up{i}.conv1", 1, 1),
                               f"{p}up{i}.bn1"))
            i += 1
        x = self.bn(self.conv(self.up2(x), p + "head.conv0", 1, 1), p + "head.bn0")
        return torch.sigmoid(self.conv(x, p + "head.conv1"))

    @staticmethod
    def up2(x):
        return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                             mode="bilinear", align_corners=False).permute(0, 2, 3, 1)

    # -- whole model -------------------------------------------------------
    def render(self, images, pose, training: bool = False):
        """images (B, T, V, H, W, 3), pose (B, T, 3) -> (B, 224, 224, 3)."""
        B, T = images.shape[:2]
        h0 = self.m["bev_shapes"][0]
        query = self.w["bev_embedding"].reshape(1, h0, h0, -1).expand(
            B, -1, -1, -1)
        prev = None
        self.training = False
        with torch.no_grad():
            for t in range(T - 1):
                prev = self.encoder(query, images[:, t], prev, pose[:, t:t + 2],
                                    True)
        pair = (pose[:, T - 2:T] if T > 1
                else torch.cat([pose, pose], dim=1))
        self.training = training
        x = self.encoder(query, images[:, -1], prev, pair, not training)
        out = self.decoder(x)
        self.training = False
        return out


def param_names(w: dict):
    """Names of the trainable tensors of a state (not BatchNorm buffers)."""
    buf = ("running_mean", "running_var", "num_batches_tracked")
    return [k for k in w if not k.endswith(buf)]


def train_steps(ref: Reference, batches, seeds, lr: float, wd: float,
                eps: float = 1e-8, clip: float = 1.0, betas=(0.9, 0.999),
                loss_rows=None):
    """Steps of MSE loss, global-norm clip and AdamW over ``batches`` (each
    a dict of camera, vehicle_pose, map), the drop-path masks of step i
    drawn from ``seeds[i]`` (``loss_rows``: the loss's mean over those rows
    alone, a planted fault). Updates ``ref.w`` in place; returns (losses,
    the first step's clipped gradients by name, the first step's render)."""
    names = param_names(ref.w)
    for n in names:
        ref.w[n].requires_grad_(True)
    m1 = {n: torch.zeros_like(ref.w[n]) for n in names}
    m2 = {n: torch.zeros_like(ref.w[n]) for n in names}
    losses, first, render1 = [], None, None
    dev = ref.w[names[0]].device
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        ref.gen = torch.Generator(device=dev)
        ref.gen.manual_seed(seed)
        out = ref.render(batch["camera"], batch["vehicle_pose"], training=True)
        rows = slice(None) if loss_rows is None else loss_rows
        loss = torch.mean((out[rows] - batch["map"][rows]) ** 2)
        if render1 is None:
            render1 = out.detach().cpu()
        grads = torch.autograd.grad(loss, [ref.w[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(ref.w[n]) if g is None else g
                 for n, g in zip(names, grads)]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        scale = clip / torch.clamp(norm, min=clip)
        grads = [g * scale for g in grads]
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        step = i + 1
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = ref.w[n]
                p.mul_(1.0 - lr * wd)
                m1[n].lerp_(g, 1.0 - betas[0])
                m2[n].mul_(betas[1]).addcmul_(g, g, value=1.0 - betas[1])
                c1 = 1.0 - betas[0] ** step
                c2 = math.sqrt(1.0 - betas[1] ** step)
                p.addcdiv_(m1[n], m2[n].sqrt() / c2 + eps, value=-lr / c1)
        losses.append(float(loss.detach()))
    for n in names:
        ref.w[n].requires_grad_(False)
    return losses, first, render1
