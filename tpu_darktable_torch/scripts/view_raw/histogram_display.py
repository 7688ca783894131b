"""Bayer-channel histogram rendering with saturation stats (counterpart of
tpu_darktable/scripts/view_raw/histogram_display.py).  The histograms are
numpy on the host: the mosaic, a tensor on any device or an array, is
copied there once (bayer_utils.extract_bayer_channels)."""

from __future__ import annotations

import numpy as np

from ..bayer_utils import extract_bayer_channels
from ...ops.bayer import BayerPattern

_COLORS = {'R': 'tab:red', 'G1': 'tab:green', 'G2': 'darkgreen', 'B': 'tab:blue'}


def draw_histograms(ax, bayer_image, pattern: BayerPattern, bins: int = 128,
                    saturation: float = 0.99, log_scale: bool = True):
    """Draw per-channel histograms onto a matplotlib axis; returns the
    per-channel saturation percentages."""
    channels = extract_bayer_channels(bayer_image, pattern)
    ax.clear()
    sat = {}
    for name, vals in channels.items():
        if vals.size == 0:
            continue
        hist, edges = np.histogram(vals, bins=bins, range=(0.0, 1.0))
        centers = 0.5 * (edges[:-1] + edges[1:])
        ax.plot(centers, hist, color=_COLORS[name], label=name, linewidth=1.0)
        sat[name] = 100.0 * float((vals >= saturation).mean())
    if log_scale:
        ax.set_yscale('log')
    ax.set_xlim(0.0, 1.0)
    ax.legend(
        [f'{n}: {sat.get(n, 0.0):.2f}% sat' for n in channels],
        loc='upper right', fontsize=8,
    )
    ax.set_title('Bayer channel histograms')
    return sat


def get_channel_means(bayer_image, pattern: BayerPattern):
    """(r_mean, g_mean, b_mean) of the raw mosaic, greens pooled
    (reference histogram_display.py:11-16)."""
    ch = extract_bayer_channels(bayer_image, pattern)
    g = np.concatenate([ch['G1'], ch['G2']]) if ch['G1'].size or ch['G2'].size else np.zeros(1)
    return (
        float(ch['R'].mean()) if ch['R'].size else 0.0,
        float(g.mean()) if g.size else 0.0,
        float(ch['B'].mean()) if ch['B'].size else 0.0,
    )


def draw_mode_histograms(ax, bayer_image, pattern: BayerPattern,
                         channel_mode: str = 'all', bins: int = 256):
    """Single-mode histogram view for the embedded panel (mirror of
    reference histogram_display.py:18-63 `create_histograms`): full (0, 1)
    range with saturated pixels INCLUDED, per-mode titles, and the green
    count halved only in 'all' mode (2x green sites per Bayer cell; a
    lone green view shows raw counts)."""
    ch = extract_bayer_channels(bayer_image, pattern)
    r = ch['R']
    g = np.concatenate([ch['G1'], ch['G2']])
    b = ch['B']

    if channel_mode == 'all':
        ax.hist(r, bins=bins, color='red', alpha=0.6, range=(0, 1),
                label='Red')
        ax.hist(g, bins=bins, color='green', alpha=0.6, range=(0, 1),
                label='Green', weights=np.full(g.size, 0.5))
        ax.hist(b, bins=bins, color='blue', alpha=0.6, range=(0, 1),
                label='Blue')
        ax.set_title('RGB Channels', color='black')
        ax.legend()
    elif channel_mode == 'red':
        ax.hist(r, bins=bins, color='red', alpha=0.8, range=(0, 1))
        ax.set_title('Red Channel', color='black')
    elif channel_mode == 'green':
        ax.hist(g, bins=bins, color='green', alpha=0.8, range=(0, 1))
        ax.set_title('Green Channel', color='black')
    elif channel_mode == 'blue':
        ax.hist(b, bins=bins, color='blue', alpha=0.8, range=(0, 1))
        ax.set_title('Blue Channel', color='black')

    ax.set_xlabel('Pixel Value', color='black')
    ax.set_ylabel('Count (Normalized)' if channel_mode == 'all' else 'Count',
                  color='black')
    ax.set_facecolor('white')
    ax.tick_params(colors='black')
    for spine in ax.spines.values():
        spine.set_color('black')
    ax.grid(True, alpha=0.3)


def draw_selective_histograms(ax, bayer_image, pattern: BayerPattern,
                              channel_states: dict, bins: int = 256,
                              saturation: float = 0.99):
    """Filled per-channel histograms with toggleable channels and saturation
    readout (reference histogram_display.py:66-115 semantics): saturated
    samples (>= 0.99) are excluded from the bars and reported as a
    percentage in each label; green counts are halved to offset the 2x
    green sites per Bayer cell.  Returns {channel: saturation_pct}."""
    ch = extract_bayer_channels(bayer_image, pattern)
    merged = {
        'Red': ch['R'],
        'Green': np.concatenate([ch['G1'], ch['G2']]),
        'Blue': ch['B'],
    }
    colors = {'Red': 'red', 'Green': 'green', 'Blue': 'blue'}
    sat = {}
    for name, vals in merged.items():
        pct = 100.0 * float((vals >= saturation).mean()) if vals.size else 0.0
        sat[name] = pct
        if not channel_states.get(name, True):
            continue
        kept = vals[vals < saturation]
        weights = np.full(kept.size, 0.5) if name == 'Green' else None
        ax.hist(kept, bins=bins, range=(0.0, saturation), color=colors[name],
                alpha=0.6, label=f'{name} ({pct:.1f}% sat)', weights=weights)
    if any(channel_states.get(n, True) for n in merged):
        ax.legend(fontsize=8)
    ax.set_xlabel('Pixel value (excluding saturated)')
    ax.set_ylabel('Count (normalized)')
    ax.grid(True, alpha=0.3)
    return sat
