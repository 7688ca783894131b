"""RCD interior cascade: wrapper of csrc/rcd_interior.cu and its plain version.

Replaces the TPU kernel tpu_darktable/kernels/rcd_interior.py:rcd_interior
(the whole 12-step RCD main sequence for pixels >= 12 px from every edge).

On the H100 the cascade is bound by its arithmetic, not by HBM: it reads the
mosaic once and writes three planes (16 bytes a pixel) but runs ~200 float
operations a pixel (unfused, --fmad=false) through 8 dependent stencil stages.  The kernel keeps all
stages of one 64x32 output tile in shared memory (tile + 12 px halo; two
full planes and five of one value per column pair), so no intermediate
plane touches HBM.  A thread owns a 2x2 Bayer quad, whose sites are fixed
at compile time, so no warp branches on a site; four stages cost 1.5x the
tile's work on average for the halo.
"""

from __future__ import annotations

import torch

from . import launch
from ..ops._stencil import Shifter

_EPS5 = 1e-5
_EPS10 = 1e-10
RING = 12  # outputs closer than this to an image edge are not valid


def rcd_interior(cfa: torch.Tensor, *, r_par: tuple[int, int],
                 b_par: tuple[int, int]) -> torch.Tensor:
    """(H, W) float32 mosaic -> (3, H, W) float32 RGB planes, valid only for
    pixels >= RING px from every edge.  `r_par`/`b_par` are the (row, col)
    parities of the R and B sites."""
    if cfa.dtype != torch.float32 or cfa.ndim != 2:
        raise RuntimeError(f'cfa must be a 2-D float32 tensor, got {cfa.dtype} {tuple(cfa.shape)}')
    if cfa.device.type == 'cpu':
        return rcd_interior_plain(cfa, r_par=r_par, b_par=b_par)
    x = cfa.contiguous()
    h, w = x.shape
    out = torch.empty((3, h, w), dtype=torch.float32, device=x.device)
    launch('rcd_interior', x.device, x, out, h, w, r_par[0], r_par[1], b_par[0], b_par[1])
    return out


def rcd_interior_plain(cfa: torch.Tensor, *, r_par: tuple[int, int],
                       b_par: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same cascade with no masks
    and no alias emulation, zero fill outside the image at every stage.
    Equal to the kernel (and to the full-frame RCD) >= RING px from every
    edge."""
    h, w = cfa.shape
    dev = cfa.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    row_odd = (rows & 1) == 1
    col_odd = (cols & 1) == 1
    m_r = ((rows & 1) == r_par[0]) & ((cols & 1) == r_par[1])
    m_b = ((rows & 1) == b_par[0]) & ((cols & 1) == b_par[1])
    m_g = ~(m_r | m_b)

    cfa = torch.clamp(cfa, min=0.0)
    s = Shifter(cfa, 4)
    c00 = cfa
    sq = lambda t: t * t

    # ---- step 1.1 / 1.2: V/H high pass and discrimination ----
    vd = sq(s(-3, 0) - 3.0 * s(-2, 0) - s(-1, 0) + 6.0 * c00 - s(1, 0) - 3.0 * s(2, 0) + s(3, 0))
    hd = sq(s(0, -3) - 3.0 * s(0, -2) - s(0, -1) + 6.0 * c00 - s(0, 1) - 3.0 * s(0, 2) + s(0, 3))
    sv, sh_ = Shifter(vd, 1), Shifter(hd, 1)
    v_stat = torch.clamp(sv(-1, 0) + vd + sv(1, 0), min=_EPS10)
    h_stat = torch.clamp(sh_(0, -1) + hd + sh_(0, 1), min=_EPS10)
    vh_dir = v_stat / (v_stat + h_stat)

    # ---- step 2.1: low pass ----
    lpf = (c00 + 0.5 * (s(-1, 0) + s(1, 0) + s(0, -1) + s(0, 1))
           + 0.25 * (s(-1, -1) + s(-1, 1) + s(1, -1) + s(1, 1)))

    # ---- step 3.1: green at R/B sites ----
    svh = Shifter(vh_dir, 1)
    vh_n = 0.25 * (svh(-1, -1) + svh(-1, 1) + svh(1, -1) + svh(1, 1))
    vh_disc = torch.where(torch.abs(0.5 - vh_dir) < torch.abs(0.5 - vh_n), vh_n, vh_dir)
    n_grad = _EPS5 + torch.abs(s(-1, 0) - s(1, 0)) + torch.abs(c00 - s(-2, 0)) + torch.abs(s(-1, 0) - s(-3, 0)) + torch.abs(s(-2, 0) - s(-4, 0))
    s_grad = _EPS5 + torch.abs(s(1, 0) - s(-1, 0)) + torch.abs(c00 - s(2, 0)) + torch.abs(s(1, 0) - s(3, 0)) + torch.abs(s(2, 0) - s(4, 0))
    w_grad = _EPS5 + torch.abs(s(0, -1) - s(0, 1)) + torch.abs(c00 - s(0, -2)) + torch.abs(s(0, -1) - s(0, -3)) + torch.abs(s(0, -2) - s(0, -4))
    e_grad = _EPS5 + torch.abs(s(0, 1) - s(0, -1)) + torch.abs(c00 - s(0, 2)) + torch.abs(s(0, 1) - s(0, 3)) + torch.abs(s(0, 2) - s(0, 4))
    sl = Shifter(lpf, 2)
    lc = lpf
    n_est = s(-1, 0) * (lc + lc) / (_EPS5 + lc + sl(-2, 0))
    s_est = s(1, 0) * (lc + lc) / (_EPS5 + lc + sl(2, 0))
    w_est = s(0, -1) * (lc + lc) / (_EPS5 + lc + sl(0, -2))
    e_est = s(0, 1) * (lc + lc) / (_EPS5 + lc + sl(0, 2))
    v_est = (s_grad * n_est + n_grad * s_est) / (n_grad + s_grad)
    h_est = (w_grad * e_est + e_grad * w_est) / (e_grad + w_grad)
    rgb1 = torch.where(m_g, c00, v_est + vh_disc * (h_est - v_est))

    # ---- step 4.1 / 4.2: P/Q high pass (plane value at (r, c|1)) ----
    pd_full = sq((s(-3, -3) - s(-1, -1) - s(1, 1) + s(3, 3)) - 3.0 * (s(-2, -2) + s(2, 2)) + 6.0 * c00)
    qd_full = sq((s(-3, 3) - s(-1, 1) - s(1, -1) + s(3, -3)) - 3.0 * (s(-2, 2) + s(2, -2)) + 6.0 * c00)
    pd = torch.where(col_odd, pd_full, Shifter(pd_full, 1)(0, 1))
    qd = torch.where(col_odd, qd_full, Shifter(qd_full, 1)(0, 1))
    sp, sq_ = Shifter(pd, 3), Shifter(qd, 3)
    p_stat = torch.where(col_odd, sp(-1, 0) + pd + sp(1, 2), sp(-1, -1) + sp(0, 1) + sp(1, 1))
    q_stat = torch.where(col_odd, sq_(-1, 2) + qd + sq_(1, 0), sq_(-1, 1) + sq_(0, 1) + sq_(1, -1))
    p_stat = torch.clamp(p_stat, min=_EPS10)
    q_stat = torch.clamp(q_stat, min=_EPS10)
    pq_dir = torch.where(m_g, 0.0, p_stat / (p_stat + q_stat))

    # Pair expansion: a column pair carries pq_dir of its non-green column.
    png_even = r_par[1] if r_par[0] == 0 else b_par[1]
    png_odd = r_par[1] if r_par[0] == 1 else b_par[1]
    spq = Shifter(pq_dir, 1)

    def _pair_val(parity):
        if parity == 0:
            return torch.where(col_odd, spq(0, -1), pq_dir)
        return torch.where(col_odd, pq_dir, spq(0, 1))

    pq = torch.where(row_odd, _pair_val(png_odd), _pair_val(png_even))

    # ---- step 5.1: R/B at opposite CFA sites ----
    sp2 = Shifter(pq, 1)
    pq_n = 0.25 * (sp2(-1, -1) + sp2(-1, 1) + sp2(1, -1) + sp2(1, 1))
    pq_disc = torch.where(torch.abs(0.5 - pq) < torch.abs(0.5 - pq_n), pq_n, pq)
    sg1 = Shifter(rgb1, 3)
    g1c = rgb1

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

    rgb0 = torch.where(m_r, c00, 0.0)
    rgb2 = torch.where(m_b, c00, 0.0)
    rgb2 = torch.where(m_r, _fill_51(rgb2), rgb2)
    rgb0 = torch.where(m_b, _fill_51(rgb0), rgb0)

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

    rgb0 = torch.where(m_g, _fill_52(rgb0), rgb0)
    rgb2 = torch.where(m_g, _fill_52(rgb2), rgb2)
    return torch.clamp(torch.stack((rgb0, rgb1, rgb2)), min=0.0)


__all__ = ['RING', 'rcd_interior', 'rcd_interior_plain']
