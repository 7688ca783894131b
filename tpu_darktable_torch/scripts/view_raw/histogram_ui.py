"""Embeddable histogram display component with channel-mode switching.

Counterpart of tpu_darktable/scripts/view_raw/histogram_ui.py (after the
reference's view_raw/histogram_ui.py): a histogram panel that lives
inside another figure, with an 'All / Red / Green / Blue' radio
overlay and zoom-scale preservation when switching channel modes.  Mode
views use the full-range mode renderer (reference create_histograms);
the saturation-filtered selective renderer belongs to the popup window.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...ops.bayer import BayerPattern

from .histogram_display import draw_mode_histograms, get_channel_means
from .ui_builder import create_clean_axes, create_radio_buttons

_MODES = ('All', 'Red', 'Green', 'Blue')


@dataclass(frozen=True)
class HistogramResult:
    """Outcome of a histogram update."""

    display_info: str
    needs_setup: bool = False


def _mode_key(mode: str) -> str:
    """Radio label -> reference channel_mode ('all'/'red'/'green'/'blue')."""
    return mode.lower()


class HistogramDisplay:
    """Histogram panel + channel radio overlay for embedding in a figure."""

    def __init__(self):
        self.channel_mode = 'All'
        self._axes = None
        self._controls_axes = None
        self._radio = None
        self._xlim = None
        self._ylim = None

    def setup_display(self, fig, rect, bayer_image, pattern: BayerPattern) -> HistogramResult:
        """Create the panel inside `fig` at figure-coords `rect`."""
        self._axes = fig.add_axes(rect)
        draw_mode_histograms(
            self._axes, np.asarray(bayer_image), pattern, _mode_key(self.channel_mode)
        )

        left, bottom, width, height = rect
        overlay = (
            left + width * 0.72,
            bottom + height * 0.85,
            width * 0.26,
            height * 0.12,
        )
        self._controls_axes = create_clean_axes(fig, overlay, zorder=20)
        self._controls_axes.patch.set_facecolor('white')
        self._controls_axes.patch.set_alpha(0.85)
        for spine in self._controls_axes.spines.values():
            spine.set_color('gray')
        self._radio = create_radio_buttons(
            self._controls_axes, list(_MODES), self.channel_mode,
            orientation='horizontal',
        )
        return HistogramResult(display_info=self._info(bayer_image, pattern))

    def update_display(self, bayer_image, pattern: BayerPattern,
                       channel_mode: str | None = None) -> HistogramResult:
        """Redraw for new data / channel mode; keeps the zoom scale when only
        the mode changed."""
        if self._axes is None:
            return HistogramResult(display_info='', needs_setup=True)

        mode_changed = channel_mode is not None and channel_mode != self.channel_mode
        if channel_mode is not None:
            self.channel_mode = channel_mode

        if mode_changed and self._xlim is not None:
            keep_x, keep_y = self._axes.get_xlim(), self._axes.get_ylim()
            self._axes.clear()
            draw_mode_histograms(
                self._axes, np.asarray(bayer_image), pattern, _mode_key(self.channel_mode)
            )
            self._axes.set_xlim(keep_x)
            self._axes.set_ylim(keep_y)
        else:
            self._axes.clear()
            draw_mode_histograms(
                self._axes, np.asarray(bayer_image), pattern, _mode_key(self.channel_mode)
            )
            self._xlim = self._axes.get_xlim()
            self._ylim = self._axes.get_ylim()
        return HistogramResult(display_info=self._info(bayer_image, pattern))

    @staticmethod
    def _info(bayer_image, pattern: BayerPattern) -> str:
        r, g, b = get_channel_means(bayer_image, pattern)
        return f'R: μ={r:.3f} | G: μ={g:.3f} | B: μ={b:.3f}'

    def get_channel_controls(self):
        """Radio widget, for the host window to bind events."""
        return self._radio


__all__ = ['HistogramDisplay', 'HistogramResult']
