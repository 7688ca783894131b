"""Live histogram (levels) window.

Counterpart of tpu_darktable/scripts/view_raw/histogram_window.py (after
the reference's view_raw/histogram_window.py): a persistent popup tied to
the main viewer — channel-toggle checkboxes, per-channel saturation
percentages in the legend, raw-Bayer channel means in the title, and
zoom/pan preservation across updates.  The main window calls
`update_display` on every navigation or settings change, so the histogram
tracks the current frame.
"""

from __future__ import annotations

import numpy as np

from ...ops.bayer import BayerPattern

from .histogram_display import draw_selective_histograms, get_channel_means
from .ui_builder import create_checkboxes, create_clean_axes


class HistogramWindow:
    """Persistent levels popup with channel toggles."""

    CHANNELS = ('Red', 'Green', 'Blue')

    def __init__(self, bayer_image, pattern: BayerPattern):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.pattern = pattern
        self.bayer_image = np.asarray(bayer_image)
        self.channel_states = dict.fromkeys(self.CHANNELS, True)

        self.fig = plt.figure(figsize=(8, 6), facecolor='white')
        manager = self.fig.canvas.manager
        if manager is not None:
            manager.set_window_title('Levels')

        self.hist_ax = self.fig.add_axes((0.1, 0.1, 0.85, 0.8))

        # Channel toggles overlaid top-right, below the legend.
        self.checkbox_ax = create_clean_axes(self.fig, (0.72, 0.55, 0.2, 0.15), zorder=20)
        self.checkbox_ax.patch.set_facecolor('white')
        self.checkbox_ax.patch.set_alpha(0.9)
        for spine in self.checkbox_ax.spines.values():
            spine.set_color('black')
        self.checkboxes = create_checkboxes(
            self.checkbox_ax, list(self.CHANNELS), [True] * 3
        )
        self.checkboxes.on_clicked(self._on_channel_toggle)

        self.update_display(bayer_image)

    def update_display(self, bayer_image, pattern: BayerPattern | None = None):
        """Redraw for a (possibly new) frame, preserving zoom/pan."""
        self.bayer_image = np.asarray(bayer_image)
        if pattern is not None:
            self.pattern = pattern

        xlim = self.hist_ax.get_xlim()
        ylim = self.hist_ax.get_ylim()
        self.hist_ax.clear()

        draw_selective_histograms(
            self.hist_ax, self.bayer_image, self.pattern, self.channel_states
        )
        r_mean, g_mean, b_mean = get_channel_means(self.bayer_image, self.pattern)
        self.hist_ax.set_title(
            f'Raw Bayer - R: μ={r_mean:.3f} | G: μ={g_mean:.3f} | B: μ={b_mean:.3f}'
        )

        # Restore non-default view limits (zoomed/panned by the user).
        if xlim != (0.0, 1.0) or ylim[0] != 0.0:
            self.hist_ax.set_xlim(xlim)
            self.hist_ax.set_ylim(ylim)
        self.fig.canvas.draw_idle()

    def _on_channel_toggle(self, label):
        self.channel_states[label] = not self.channel_states[label]
        self.update_display(self.bayer_image)

    def show(self):
        self.fig.show()

    def close(self):
        if self.fig is not None:
            self.plt.close(self.fig)

    def is_open(self) -> bool:
        return self.fig is not None and self.plt.fignum_exists(self.fig.number)


__all__ = ['HistogramWindow']
