"""RCD (Ratio Corrected Demosaic), counterpart of tpu_darktable/ops/rcd.py.

Two paths with one result:

- `_rcd_full`: the plain full-frame sequence (the JAX package's `_rcd_xla`),
  with the reference's half-grid buffer aliasing reproduced when
  `strict_alias` (stale reads of the v/h high-pass, `_halfgrid_plane`) and
  the border ladder run on edge strips.
- `_rcd_kernel_path`: the interior (>= _RING px from every edge) from the
  hand-written kernel (kernels/rcd_interior.py), the ring and the border
  ladder from `_rcd_full` on _STRIP-wide edge strips, with the global stale
  planes injected so the ring matches the full-frame path exactly.

Even width and height are required: the half-grid emulation relies on it.

`dual_demosaic` blends RCD with the bilinear demosaic by a detail mask.
"""

from __future__ import annotations

import torch

from .._device import scalar_on
from .._validate import as_mosaic
from ..kernels.rcd_interior import rcd_interior
from ..utils import timing
from .bayer import BayerPattern, site_parities
from .demosaic import bilinear5x5_demosaic, border_interpolate, ppg_green, ppg_redblue
from ._stencil import Shifter, interior_mask, row_col_iota, site_masks

_F32 = torch.float32
_EPS5 = 1e-5
_EPS10 = 1e-10
RCD_MARGIN = 7

_RING = 12   # px of output taken from the plain edge strips
_STRIP = 32  # strip height/width (>= _RING + inner-edge contamination ~16)


def _region(h, w, r0, r1, c0, c1, device):
    rows, cols = row_col_iota(h, w, device)
    return (rows >= r0) & (rows <= r1) & (cols >= c0) & (cols <= c1)


def _sq(x):
    return x * x


def _halfgrid_plane(values_full, background_full, h, w, r0, r1, c0, c1,
                    strict_alias=True, stale=None):
    """Emulate the reference's half-grid buffer with stale-alias background.

    The reference writes `plane[idx/2]` at odd columns of rows [r0, r1] into
    a buffer that still holds `background` (the v/h high-pass) elsewhere;
    a read at slot s returns the written value when {2s, 2s+1} holds a
    written site, else the stale background at flat index s.  Returns the
    full-grid F with F[r, c] = buffer[(r*w + c)//2].

    `stale`: optional precomputed (h, w//2) stale plane, for edge strips
    whose stale values come from the FULL image's flat indexing.
    """
    slots = values_full[:, 1::2]
    written = _region(h, w // 2, r0, r1, (c0 - 1) // 2, (c1 - 1) // 2, values_full.device)
    if stale is None:
        if strict_alias:
            stale = background_full.reshape(h * w)[: h * (w // 2)].reshape(h, w // 2)
        else:
            stale = torch.zeros((), dtype=_F32, device=values_full.device)
    plane = torch.where(written, slots, stale)
    return torch.repeat_interleave(plane, 2, dim=-1)


def rcd_demosaic(image: torch.Tensor, pattern: BayerPattern,
                 strict_alias: bool = True) -> torch.Tensor:
    """Full RCD: border ladder + 12-step main sequence.

    Args:
        image: (H, W) or (H, W, 1) float32 mosaic, even dimensions.
        pattern: CFA pattern.
        strict_alias: replicate the reference's half-grid stale reads.

    A CUDA tensor takes the kernel path (kernel interior + plain edge strips),
    a CPU tensor the plain full-frame path.

    Returns:
        (H, W, 3) RGB.
    """
    x = as_mosaic(image, 'image', dtype=_F32)
    h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f'RCD requires even dimensions, got {h}x{w}')
    # The size rule is part of the semantics, not a fallback: below 96 px
    # the _STRIP-wide edge strips would overlap, so small frames always run
    # the full-frame sequence (the same rule as the JAX package).
    if x.is_cuda and h >= 96 and w >= 96:
        return _rcd_kernel_path(x, pattern, strict_alias)
    return _rcd_full(x, pattern, strict_alias)


def _vh_highpass(x: torch.Tensor):
    """Global V/H squared high-pass planes: the stale-alias background."""
    h, w = x.shape
    s = Shifter(torch.clamp(x, min=0.0), 4)
    c00 = s(0, 0)
    vd = _sq(s(-3, 0) - 3.0 * s(-2, 0) - s(-1, 0) + 6.0 * c00
             - s(1, 0) - 3.0 * s(2, 0) + s(3, 0))
    hd = _sq(s(0, -3) - 3.0 * s(0, -2) - s(0, -1) + 6.0 * c00
             - s(0, 1) - 3.0 * s(0, 2) + s(0, 3))
    r34 = _region(h, w, 3, h - 4, 3, w - 4, x.device)
    return torch.where(r34, vd, 0.0), torch.where(r34, hd, 0.0)


def _rcd_kernel_path(x: torch.Tensor, pattern: BayerPattern, strict_alias: bool):
    """Kernel interior + plain edge strips (the JAX package's _rcd_pallas)."""
    h, w = x.shape
    rp, bp = site_parities(pattern)
    interior = rcd_interior(x, r_par=rp, b_par=bp).permute(1, 2, 0)
    timing.mark('rcd.interior')   # from here to the demosaic mark: the edge strips and the cats
    top, bottom, left, right = _rcd_edge_strips(x, pattern, strict_alias)
    r = _RING
    mid = torch.cat([left[r : h - r, :r], interior[r : h - r, r : w - r],
                     right[r : h - r, -r:]], dim=1)
    return torch.cat([top[:r], mid, bottom[-r:]], dim=0)


def _rcd_edge_strips(x: torch.Tensor, pattern: BayerPattern, strict_alias: bool):
    """The plain path on the four _STRIP-wide edge strips (top, bottom, left,
    right), with the global stale planes injected when strict_alias."""
    h, w = x.shape
    s = _STRIP
    left_x, right_x = x[:, :s].contiguous(), x[:, w - s:].contiguous()
    if not strict_alias:
        return (_rcd_full(x[:s], pattern, False), _rcd_full(x[h - s:], pattern, False),
                _rcd_full(left_x, pattern, False), _rcd_full(right_x, pattern, False))
    vd, hd = _vh_highpass(x)
    stale_v = vd.reshape(h * w)[: h * (w // 2)].reshape(h, w // 2)
    stale_h = hd.reshape(h * w)[: h * (w // 2)].reshape(h, w // 2)
    # The top strip's local flat indexing equals the global one.
    return (
        _rcd_full(x[:s], pattern, True),
        _rcd_full(x[h - s:], pattern, True, stale_v[h - s:], stale_h[h - s:]),
        _rcd_full(left_x, pattern, True, stale_v[:, : s // 2], stale_h[:, : s // 2]),
        _rcd_full(right_x, pattern, True, stale_v[:, (w - s) // 2:], stale_h[:, (w - s) // 2:]),
    )


def _rcd_full(x: torch.Tensor, pattern: BayerPattern, strict_alias: bool,
              stale_v=None, stale_h=None) -> torch.Tensor:
    """The plain full-frame RCD sequence (optionally with injected stale
    planes); step numbers are those of the reference's rcd.cu."""
    h, w = x.shape
    dev = x.device
    masks = site_masks(h, w, pattern, dev)
    m_g = masks['g']
    _, cols = row_col_iota(h, w, dev)
    col_odd = (cols & 1) == 1

    # ---- populate ----
    cfa = torch.clamp(x, min=0.0)
    rgb0 = torch.where(masks['r'], cfa, 0.0)
    rgb1 = torch.where(m_g, cfa, 0.0)
    rgb2 = torch.where(masks['b'], cfa, 0.0)

    s = Shifter(cfa, 4)
    c00 = s(0, 0)

    # ---- step 1.1: V/H squared high pass ----
    vd = _sq(s(-3, 0) - 3.0 * s(-2, 0) - s(-1, 0) + 6.0 * c00 - s(1, 0) - 3.0 * s(2, 0) + s(3, 0))
    hd = _sq(s(0, -3) - 3.0 * s(0, -2) - s(0, -1) + 6.0 * c00 - s(0, 1) - 3.0 * s(0, 2) + s(0, 3))
    r34 = _region(h, w, 3, h - 4, 3, w - 4, dev)
    vd = torch.where(r34, vd, 0.0)
    hd = torch.where(r34, hd, 0.0)

    # ---- step 1.2: V/H local discrimination ----
    sv = Shifter(vd, 1)
    sh = Shifter(hd, 1)
    v_stat = torch.clamp(sv(-1, 0) + sv(0, 0) + sv(1, 0), min=_EPS10)
    h_stat = torch.clamp(sh(0, -1) + sh(0, 0) + sh(0, 1), min=_EPS10)
    vh_dir = torch.where(_region(h, w, 2, h - 3, 2, w - 3, dev), v_stat / (v_stat + h_stat), 0.0)

    # ---- step 2.1: low pass at non-green sites (full grid suffices) ----
    lpf = (
        c00
        + 0.5 * (s(-1, 0) + s(1, 0) + s(0, -1) + s(0, 1))
        + 0.25 * (s(-1, -1) + s(-1, 1) + s(1, -1) + s(1, 1))
    )

    # ---- step 3.1: green at R/B sites ----
    svh = Shifter(vh_dir, 1)
    vh_c = svh(0, 0)
    vh_n = 0.25 * (svh(-1, -1) + svh(-1, 1) + svh(1, -1) + svh(1, 1))
    vh_disc = torch.where(torch.abs(0.5 - vh_c) < torch.abs(0.5 - vh_n), vh_n, vh_c)

    n_grad = _EPS5 + torch.abs(s(-1, 0) - s(1, 0)) + torch.abs(c00 - s(-2, 0)) + torch.abs(s(-1, 0) - s(-3, 0)) + torch.abs(s(-2, 0) - s(-4, 0))
    s_grad = _EPS5 + torch.abs(s(1, 0) - s(-1, 0)) + torch.abs(c00 - s(2, 0)) + torch.abs(s(1, 0) - s(3, 0)) + torch.abs(s(2, 0) - s(4, 0))
    w_grad = _EPS5 + torch.abs(s(0, -1) - s(0, 1)) + torch.abs(c00 - s(0, -2)) + torch.abs(s(0, -1) - s(0, -3)) + torch.abs(s(0, -2) - s(0, -4))
    e_grad = _EPS5 + torch.abs(s(0, 1) - s(0, -1)) + torch.abs(c00 - s(0, 2)) + torch.abs(s(0, 1) - s(0, 3)) + torch.abs(s(0, 2) - s(0, 4))

    sl = Shifter(lpf, 2)
    lc = sl(0, 0)
    n_est = s(-1, 0) * (lc + lc) / (_EPS5 + lc + sl(-2, 0))
    s_est = s(1, 0) * (lc + lc) / (_EPS5 + lc + sl(2, 0))
    w_est = s(0, -1) * (lc + lc) / (_EPS5 + lc + sl(0, -2))
    e_est = s(0, 1) * (lc + lc) / (_EPS5 + lc + sl(0, 2))

    v_est = (s_grad * n_est + n_grad * s_est) / (n_grad + s_grad)
    h_est = (w_grad * e_est + e_grad * w_est) / (e_grad + w_grad)
    green_val = v_est + vh_disc * (h_est - v_est)

    site31 = (~m_g) & _region(h, w, 4, h - 5, 4, w - 5, dev)
    rgb1 = torch.where(site31, green_val, rgb1)

    # ---- step 4.1: P/Q diagonal high pass at odd columns ----
    pd_full = _sq((s(-3, -3) - s(-1, -1) - s(1, 1) + s(3, 3)) - 3.0 * (s(-2, -2) + s(2, 2)) + 6.0 * c00)
    qd_full = _sq((s(-3, 3) - s(-1, 1) - s(1, -1) + s(3, -3)) - 3.0 * (s(-2, 2) + s(2, -2)) + 6.0 * c00)
    # The half-grid planes share the v/h diff buffers in the reference.
    pd = _halfgrid_plane(pd_full, vd, h, w, 3, h - 4, 3, w - 4, strict_alias, stale=stale_v)
    qd = _halfgrid_plane(qd_full, hd, h, w, 3, h - 4, 3, w - 4, strict_alias, stale=stale_h)

    # ---- step 4.2: P/Q local discrimination ----
    # The slot arithmetic resolves to column-parity-dependent reads:
    #   P: (r-1, odd(c-1)), (r, odd(c)), (r+1, odd(c-1)+2)
    #   Q: (r-1, odd(c-1)+2), (r, odd(c)), (r+1, odd(c-1))
    sp = Shifter(pd, 3)
    sq = Shifter(qd, 3)
    p_stat = torch.where(col_odd, sp(-1, 0) + sp(0, 0) + sp(1, 2), sp(-1, -1) + sp(0, 1) + sp(1, 1))
    q_stat = torch.where(col_odd, sq(-1, 2) + sq(0, 0) + sq(1, 0), sq(-1, 1) + sq(0, 1) + sq(1, -1))
    p_stat = torch.clamp(p_stat, min=_EPS10)
    q_stat = torch.clamp(q_stat, min=_EPS10)
    pq_raw = p_stat / (p_stat + q_stat)
    pq_dir = torch.where(_region(h, w, 2, h - 3, 2, w - 3, dev) & ~m_g, pq_raw, 0.0)
    # Expand the half-grid slots: both columns of a pair carry the value of
    # the pair's non-green column.
    pq_pairs = torch.where((~m_g)[:, 0::2], pq_dir[:, 0::2], pq_dir[:, 1::2])
    pq = torch.repeat_interleave(pq_pairs, 2, dim=-1)

    # ---- step 5.1: R/B at opposite CFA sites ----
    spq = Shifter(pq, 1)
    pq_c = spq(0, 0)
    pq_n = 0.25 * (spq(-1, -1) + spq(-1, 1) + spq(1, -1) + spq(1, 1))
    pq_disc = torch.where(torch.abs(0.5 - pq_c) < torch.abs(0.5 - pq_n), pq_n, pq_c)

    sg1 = Shifter(rgb1, 3)
    g1c = sg1(0, 0)
    r51 = _region(h, w, 4, h - 4, 4, w - 4, dev)

    def _fill_51(rgbc):
        rc = Shifter(rgbc, 3)
        nw_grad = _EPS5 + torch.abs(rc(-1, -1) - rc(1, 1)) + torch.abs(rc(-1, -1) - rc(-3, -3)) + torch.abs(g1c - sg1(-2, -2))
        ne_grad = _EPS5 + torch.abs(rc(-1, 1) - rc(1, -1)) + torch.abs(rc(-1, 1) - rc(-3, 3)) + torch.abs(g1c - sg1(-2, 2))
        sw_grad = _EPS5 + torch.abs(rc(-1, 1) - rc(1, -1)) + torch.abs(rc(1, -1) - rc(3, -3)) + torch.abs(g1c - sg1(2, -2))
        se_grad = _EPS5 + torch.abs(rc(-1, -1) - rc(1, 1)) + torch.abs(rc(1, 1) - rc(3, 3)) + torch.abs(g1c - sg1(2, 2))
        nw_est = rc(-1, -1) - sg1(-1, -1)
        ne_est = rc(-1, 1) - sg1(-1, 1)
        sw_est = rc(1, -1) - sg1(1, -1)
        se_est = rc(1, 1) - sg1(1, 1)
        p_est = (nw_grad * se_est + se_grad * nw_est) / (nw_grad + se_grad)
        q_est = (ne_grad * sw_est + sw_grad * ne_est) / (ne_grad + sw_grad)
        return g1c + (p_est + pq_disc * (q_est - p_est))

    # At an R site fill blue, at a B site fill red.
    rgb2 = torch.where(masks['r'] & r51, _fill_51(rgb2), rgb2)
    rgb0 = torch.where(masks['b'] & r51, _fill_51(rgb0), rgb0)

    # ---- step 5.2: R/B at green sites ----
    n1 = _EPS5 + torch.abs(g1c - sg1(-2, 0))
    s1 = _EPS5 + torch.abs(g1c - sg1(2, 0))
    w1 = _EPS5 + torch.abs(g1c - sg1(0, -2))
    e1 = _EPS5 + torch.abs(g1c - sg1(0, 2))

    def _fill_52(rgbc):
        rc = Shifter(rgbc, 3)
        sn_abs = torch.abs(rc(-1, 0) - rc(1, 0))
        ew_abs = torch.abs(rc(0, -1) - rc(0, 1))
        n_g = n1 + sn_abs + torch.abs(rc(-1, 0) - rc(-3, 0))
        s_g = s1 + sn_abs + torch.abs(rc(1, 0) - rc(3, 0))
        w_g = w1 + ew_abs + torch.abs(rc(0, -1) - rc(0, -3))
        e_g = e1 + ew_abs + torch.abs(rc(0, 1) - rc(0, 3))
        n_e = rc(-1, 0) - sg1(-1, 0)
        s_e = rc(1, 0) - sg1(1, 0)
        w_e = rc(0, -1) - sg1(0, -1)
        e_e = rc(0, 1) - sg1(0, 1)
        v_est = (n_g * s_e + s_g * n_e) / (n_g + s_g)
        h_est = (e_g * w_e + w_g * e_e) / (e_g + w_g)
        return g1c + (v_est + vh_disc * (h_est - v_est))

    g52 = m_g & r51
    rgb0 = torch.where(g52, _fill_52(rgb0), rgb0)
    rgb2 = torch.where(g52, _fill_52(rgb2), rgb2)

    # ---- output inside RCD_MARGIN + the border ladder ring ----
    # Only a RCD_MARGIN-wide ring of the border ladder survives, and its
    # dependencies reach ~11 px inward, so the ladder runs on edge strips.
    rgb = torch.clamp(torch.stack((rgb0, rgb1, rgb2), dim=-1), min=0.0)
    m = RCD_MARGIN
    strip = 16  # ring(7) + redblue(1) + green(3) + interp context
    if h <= 2 * strip + 2 or w <= 2 * strip + 2:
        out = _border_ladder(x, pattern)
        keep = interior_mask(h, w, m, dev)
        return torch.where(keep[..., None], rgb, out)

    top = _border_ladder(x[:strip], pattern)[:m]
    bottom = _border_ladder(x[-strip:], pattern)[-m:]
    left = _border_ladder(x[:, :strip], pattern)[m : h - m, :m]
    right = _border_ladder(x[:, -strip:], pattern)[m : h - m, -m:]
    mid = torch.cat([left, rgb[m : h - m, m : w - m], right], dim=1)
    return torch.cat([top, mid, bottom], dim=0)


def _border_ladder(x: torch.Tensor, pattern: BayerPattern) -> torch.Tensor:
    """The reference's three-pass border fill (border_interpolate 3 ->
    border green 32 -> border red/blue 16) on the given (sub-)image."""
    h, w = x.shape
    dev = x.device
    out = border_interpolate(x, pattern, 3)
    green_b = ppg_green(x, pattern, clamp_input=True)
    green_ring = interior_mask(h, w, 3, dev) & ~interior_mask(h, w, 32, dev)
    out = torch.where(green_ring[..., None], green_b, out)
    rb_b = ppg_redblue(out, pattern, clamp_input=True)
    rb_ring = ~interior_mask(h, w, 16, dev)
    return torch.where(rb_ring[..., None], rb_b, out)


# ---------------------------------------------------------------------------
# The dual demosaic: RCD where the frame has detail, bilinear where it is
# smooth, blended by a sigmoid of a Scharr gradient of a luminance proxy.
# ---------------------------------------------------------------------------

def calc_blend_factor(value, threshold):
    """Sigmoid blend factor, inflexion at (threshold, 0.5)."""
    value = torch.as_tensor(value, dtype=_F32)
    return 1.0 / (1.0 + torch.exp(16.0 - (16.0 / threshold) * value))


def calc_y0_mask(rgb, red: float, green: float, blue: float):
    """Luminance-proxy mask sqrt(mean(max(channel / coeff, 0)))."""
    rgb = torch.as_tensor(rgb, dtype=_F32)
    dev = rgb.device
    val = (torch.clamp(rgb[..., 0] / scalar_on(red, dev), min=0.0)
           + torch.clamp(rgb[..., 1] / scalar_on(green, dev), min=0.0)
           + torch.clamp(rgb[..., 2] / scalar_on(blue, dev), min=0.0))
    return torch.sqrt(val / scalar_on(3.0, dev))


def calc_scharr_mask(mask):
    """Scharr gradient magnitude / 16, clipped to [0, 1]; edge pixels take
    the value of the row or column one inside."""
    x = torch.as_tensor(mask, dtype=_F32)
    s = Shifter(x, 1, mode='constant')
    gx = (47.0 / 255.0) * (s(-1, -1) - s(-1, 1) + s(1, -1) - s(1, 1)) + (162.0 / 255.0) * (
        s(0, -1) - s(0, 1))
    gy = (47.0 / 255.0) * (s(-1, -1) - s(1, -1) + s(-1, 1) - s(1, 1)) + (162.0 / 255.0) * (
        s(-1, 0) - s(1, 0))
    grad = torch.clamp(torch.hypot(gx, gy) / 16.0, 0.0, 1.0)
    grad = torch.cat([grad[1:2], grad[1:-1], grad[-2:-1]], dim=0)
    return torch.cat([grad[:, 1:2], grad[:, 1:-1], grad[:, -2:-1]], dim=1)


def calc_detail_blend(mask, threshold: float, detail: bool):
    """Blend map from a detail mask: high where detailed, or the inverse."""
    blend = torch.clamp(calc_blend_factor(mask, threshold), 0.0, 1.0)
    return blend if detail else 1.0 - blend


def blend_dual(high, low, blend_mask, show_mask: bool = False):
    """max(lerp(low, high, blend), 0) per pixel; with `show_mask` the
    blend map rides along as a fourth channel."""
    high = torch.as_tensor(high, dtype=_F32)
    low = torch.as_tensor(low, dtype=_F32)
    b = torch.as_tensor(blend_mask, dtype=_F32)[..., None]
    out = torch.clamp((1.0 - b) * low + b * high, min=0.0)
    if show_mask:
        return torch.cat([out, b], dim=-1)
    return out


def dual_demosaic(image, pattern: BayerPattern, threshold: float = 0.15,
                  wb=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Dual demosaic on the image's device: RCD where detailed, bilinear
    where smooth."""
    high = rcd_demosaic(image, pattern)
    low = bilinear5x5_demosaic(image, pattern)
    y0 = calc_y0_mask(high, *wb)
    scharr = calc_scharr_mask(y0)
    blend = calc_detail_blend(scharr, threshold, detail=True)
    return blend_dual(high, low, blend)


__all__ = [
    'RCD_MARGIN',
    'blend_dual',
    'calc_blend_factor',
    'calc_detail_blend',
    'calc_scharr_mask',
    'calc_y0_mask',
    'dual_demosaic',
    'rcd_demosaic',
]
