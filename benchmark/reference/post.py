"""From a traced G-buffer to display colours and ANSI-256 indices.

1. TAA: blend the history into the frame (alpha ``taa_alpha``), after
   scaling the history's luminance into the same-sky 3x3 neighbourhood's
   range (padded by ``taa_luminance_pad``); disoccluded pixels (sky flip,
   depth change over 5%, normals apart by more than acos 0.8) take the
   frame alone, and so does every pixel when the camera moved or there is
   no history.
2. À-trous: ``atrous_iterations`` edge-aware 5x5 B3-spline passes
   dilated 1, 2, 4, the tap weights exp(-(dl/c + dn/n + dz/z + da/a));
   sky pixels pass through, and cross-sky taps count for nothing.
3. Auto-exposure: the log-average luminance of every second row and
   column off the sky, an EMA towards key / average within [min, max].
4. ACES filmic curve, gamma, saturation; then the nearest xterm-256
   colour (6-level cube, or the gray ramp for low-chroma colours when
   nearer by a penalty of 64).

Neighbourhood reads clamp their indices to the image edge. Images are
(H, W, 3) inside, (3, H, W) at the boundary.
"""

from __future__ import annotations

import numpy as np
import torch

FAR_DEPTH = 3.4e38
INF = 3.0e38
K5 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
CUBE = np.array([0, 95, 135, 175, 215, 255], np.float32)
GRAY = np.array([8 + 10 * i for i in range(24)], np.float32)


def luma(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def unit(v):
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])
    return v / torch.clamp(n, min=1e-20)[..., None]


def shifted(a, oy: int, ox: int):
    h, w = a.shape[:2]
    rows = torch.clamp(torch.arange(h, device=a.device) + oy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=a.device) + ox, 0, w - 1)
    return a[rows][:, cols]


def should_reset(pos, yaw, pitch, last_pos, last_yaw, last_pitch, have,
                 cfg):
    d = pos - last_pos
    moved = ((torch.sqrt((d * d).sum(-1)) > cfg["motion_trans_reset"])
             | ((yaw - last_yaw).abs() > cfg["motion_rot_reset"])
             | ((pitch - last_pitch).abs() > cfg["motion_rot_reset"]))
    return have & moved


def taa(cur, normal, depth, sky, history, prev_normal, prev_depth, prev_sky,
        history_valid, reset, cfg):
    alpha = min(max(cfg["taa_alpha"], 0.0), 1.0)
    nonfinite = ~(torch.isfinite(depth) & torch.isfinite(prev_depth))
    rel = (depth - prev_depth).abs() / torch.clamp(
        torch.minimum(depth, prev_depth), min=1e-4)
    a, b = unit(normal), unit(prev_normal)
    ndot = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    react = (sky != prev_sky) | nonfinite | (rel > 0.05) | (ndot < 0.8)
    local_alpha = torch.where(react, 1.0, alpha).to(cur.dtype)
    lum = luma(cur)
    r = max(0, cfg["taa_clamp_radius"])
    lo = torch.full_like(lum, float("inf"))
    hi = torch.full_like(lum, float("-inf"))
    for oy in range(-r, r + 1):
        for ox in range(-r, r + 1):
            ls = shifted(lum, oy, ox)
            ok = shifted(sky, oy, ox) == sky
            lo = torch.minimum(lo, torch.where(ok, ls, float("inf")))
            hi = torch.maximum(hi, torch.where(ok, ls, float("-inf")))
    span = hi - lo
    l_min = lo - span * cfg["taa_luminance_pad"]
    l_max = hi + span * cfg["taa_luminance_pad"]
    prev_l = luma(history)
    safe = torch.clamp(prev_l, min=1e-6)
    scale = torch.where(prev_l > l_max, l_max / safe,
                        torch.where(prev_l < l_min, l_min / safe, 1.0))
    a3 = local_alpha[..., None]
    blended = history * scale[..., None] * (1.0 - a3) + cur * a3
    return torch.where(reset | ~history_valid, cur, blended)


def atrous(src, albedo, normal, depth, sky, cfg):
    n0 = unit(normal)
    inv = [1.0 / max(1e-6, cfg[k]) for k in
           ("atrous_c_phi", "atrous_n_phi", "atrous_z_phi", "atrous_a_phi")]
    cur = src
    for it in range(max(1, cfg["atrous_iterations"])):
        step = 1 << it
        lum0 = luma(cur)
        accum = torch.zeros_like(cur)
        wsum = torch.zeros_like(lum0)
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                oy, ox = ky * step, kx * step
                c = shifted(cur, oy, ox)
                a = shifted(albedo, oy, ox)
                n = shifted(n0, oy, ox)
                dl = (luma(c) - lum0).abs()
                dn = torch.clamp(1.0 - (n0[..., 0] * n[..., 0]
                                        + n0[..., 1] * n[..., 1]
                                        + n0[..., 2] * n[..., 2]), min=0.0)
                dz = (shifted(depth, oy, ox) - depth).abs()
                da = ((a[..., 0] - albedo[..., 0]).abs()
                      + (a[..., 1] - albedo[..., 1]).abs()
                      + (a[..., 2] - albedo[..., 2]).abs())
                w = K5[kx + 2] * K5[ky + 2] * torch.exp(
                    -(dl * inv[0] + dn * inv[1] + dz * inv[2] + da * inv[3]))
                w = torch.where(shifted(sky, oy, ox) == sky, w, 0.0)
                accum = accum + c * w[..., None]
                wsum = wsum + w
        out = torch.where((wsum > 1e-8)[..., None],
                          accum / torch.clamp(wsum, min=1e-8)[..., None], cur)
        cur = torch.where(sky[..., None], cur, out)
    return cur


def exposure(hdr, sky, ae, cfg):
    """(new auto-exposure, effective exposure)."""
    if not cfg["auto_exposure"]:
        return ae, cfg["tone_exposure"] * ae
    lum = luma(hdr[0::2, ::2])
    use = (~sky[0::2, ::2]) & (lum > 0.0)
    log_sum = torch.where(use, torch.log(1e-6 + lum), 0.0).sum()
    count = use.sum()
    avg = torch.exp(log_sum / torch.clamp(count, min=1))
    target = torch.clamp(cfg["ae_key"] / torch.clamp(avg, min=1e-6),
                         cfg["ae_min"], cfg["ae_max"])
    target = torch.where(count > 0, target, ae)
    rate = float(np.float32(1.0) - np.exp(-np.float32(cfg["ae_speed"])))
    new = ae + (target - ae) * rate
    return new, cfg["tone_exposure"] * new


def tone_map(hdr, exp, cfg):
    x = torch.clamp(hdr, min=0.0) * exp
    num = x * (2.51 * x + 0.03)
    den = x * (2.43 * x + 0.59) + 0.14
    c = torch.clamp(torch.where(den > 0.0, num / den, 0.0), 0.0, 1.0)
    c = torch.pow(torch.clamp(c, 0.0, 1.0), 1.0 / max(0.1, cfg["tone_gamma"]))
    y = luma(c)[..., None]
    chroma = c.amax(-1, keepdim=True) - c.amin(-1, keepdim=True)
    f = cfg["tone_saturation"] * (1.0 + cfg["tone_vibrance"] * (1.0 - chroma))
    return torch.clamp(y + (c - y) * f, 0.0, 1.0)


def srgb8(c):
    c = torch.clamp(c, 0.0, 1.0)
    s = torch.where(c <= 0.0031308, 12.92 * c,
                    1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    return torch.round(torch.clamp(s * 255.0, 0.0, 255.0))


def ansi256(rgb):
    r, g, b = (srgb8(rgb[..., i]) for i in range(3))
    lvl = lambda v: ((v >= 48).to(torch.int32) + (v >= 114).to(torch.int32)
                     + (v >= 154).to(torch.int32) + (v >= 194).to(torch.int32)
                     + (v >= 234).to(torch.int32))
    ir, ig, ib = lvl(r), lvl(g), lvl(b)
    cube = torch.from_numpy(CUBE).to(rgb.device, rgb.dtype)
    cr, cg, cb = cube[ir.long()], cube[ig.long()], cube[ib.long()]
    y = srgb8(0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
              + 0.0722 * rgb[..., 2])
    gi = torch.clamp(torch.round((y - 8.0) / 10.0), 0, 23).to(torch.int32)
    gv = torch.from_numpy(GRAY).to(rgb.device, rgb.dtype)[gi.long()]
    chroma = torch.maximum((r - g).abs(),
                           torch.maximum((r - b).abs(), (g - b).abs()))
    d_cube = (r - cr) ** 2 + (g - cg) ** 2 + (b - cb) ** 2
    d_gray = (r - gv) ** 2 + (g - gv) ** 2 + (b - gv) ** 2 + 64.0
    return torch.where((chroma <= 18.0) & (d_gray < d_cube), 232 + gi,
                       16 + 36 * ir + 6 * ig + ib).to(torch.int32)


def post(gbuf, prev_gbuf, history, history_valid, reset, ae, cfg):
    """(blended (3, H, W), mapped (3, H, W), ANSI (H, W), new exposure)."""
    hwc = lambda p: p.permute(1, 2, 0)
    far = torch.tensor(FAR_DEPTH).to(gbuf.dtype)   # inf in bfloat16
    guide = lambda z: torch.where(z >= INF, far.to(z.device), z)
    sky = gbuf[3] > 0.5
    depth = guide(gbuf[10])
    normal = hwc(gbuf[7:10])
    blended = taa(hwc(gbuf[0:3]), normal, depth, sky, hwc(history),
                  hwc(prev_gbuf[7:10]), guide(prev_gbuf[10]),
                  prev_gbuf[3] > 0.5, history_valid, reset, cfg)
    denoised = atrous(blended, hwc(gbuf[4:7]), normal, depth, sky, cfg)
    new_ae, exp = exposure(denoised, sky, ae, cfg)
    mapped = tone_map(denoised, exp, cfg)
    chw = lambda x: x.permute(2, 0, 1).contiguous()
    return chw(blended), chw(mapped), ansi256(mapped), new_ae
