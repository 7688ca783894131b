"""Persistent JPEG preview / quality-explorer window.

Counterpart of tpu_darktable/scripts/view_raw/jpeg_preview_window.py: the
codec is this package's own JPEG encoder (ops/jpeg.py), run on `device`
(None = the card), with Pillow decoding the preview: quality slider +
progressive toggle, decoded preview, and a file-size / PSNR readout.  The
main window calls `update_display` on navigation and settings changes so
the preview follows the current frame.
"""

from __future__ import annotations

import numpy as np

from .jpeg_utils import decode_jpeg_bytes, encode_jpeg_bytes, jpeg_psnr
from .ui_builder import create_checkboxes, create_clean_axes


def apply_jpeg_filter(rgb_u8: np.ndarray, quality: int, progressive: bool, device=None):
    """Round-trip an RGB uint8 image through our encoder on `device`.

    Returns (decoded_rgb, file_size_bytes, psnr_db).
    """
    data = encode_jpeg_bytes(rgb_u8, quality=quality, progressive=progressive, device=device)
    decoded = decode_jpeg_bytes(data)
    return decoded, len(data), jpeg_psnr(rgb_u8, decoded)


class JpegPreviewWindow:
    """Popup showing the current frame as it would encode to disk."""

    def __init__(self, get_image, device=None):
        """`get_image`: zero-arg callable returning the current processed
        uint8 RGB frame (the main UI's pipeline output); `device` encodes
        it (None = the card)."""
        import matplotlib.pyplot as plt

        self.plt = plt
        self._get_image = get_image
        self.device = device
        self.jpeg_quality = 95
        self.jpeg_progressive = False

        self.fig = plt.figure(figsize=(10, 8), facecolor='white')
        manager = self.fig.canvas.manager
        if manager is not None:
            manager.set_window_title('JPEG Preview')

        self.img_ax = self.fig.add_axes((0.05, 0.25, 0.9, 0.7))
        self.img_ax.set_aspect('equal')
        self.img_ax.axis('off')
        self.im = None

        from matplotlib.widgets import Slider

        self.slider_ax = self.fig.add_axes((0.15, 0.12, 0.6, 0.04))
        self.quality_slider = Slider(
            self.slider_ax, 'Quality', 1, 100, valinit=self.jpeg_quality, valfmt='%d'
        )
        self.quality_slider.on_changed(self._on_quality_change)

        self.checkbox_ax = create_clean_axes(
            self.fig, (0.15, 0.05, 0.3, 0.05), frame=False
        )
        self.progressive_checkbox = create_checkboxes(
            self.checkbox_ax, ['Progressive'], [self.jpeg_progressive]
        )
        self.progressive_checkbox.on_clicked(self._on_progressive_toggle)

        self.info_ax = create_clean_axes(self.fig, (0.5, 0.05, 0.4, 0.05), frame=False)
        self.info_text = self.info_ax.text(0, 0.5, '', fontsize=10, verticalalignment='center')

        self.update_display()

    def update_display(self, processed_image: np.ndarray | None = None):
        """Re-encode + redraw; pass the frame to skip re-running the pipeline."""
        if processed_image is None:
            processed_image = self._get_image()
        decoded, size, psnr = apply_jpeg_filter(
            np.asarray(processed_image), self.jpeg_quality, self.jpeg_progressive, self.device
        )

        if self.im is None:
            self.im = self.img_ax.imshow(decoded, aspect='equal', interpolation='nearest')
        else:
            self.im.set_data(decoded)
            h, w = decoded.shape[:2]
            self.im.set_extent((0, w, h, 0))

        self.info_text.set_text(f'{size / (1024 * 1024):.2f} MB | {psnr:.1f} dB PSNR')
        self.fig.canvas.draw_idle()

    def _on_quality_change(self, val):
        self.jpeg_quality = int(val)
        self.update_display()

    def _on_progressive_toggle(self, _label):
        self.jpeg_progressive = not self.jpeg_progressive
        self.update_display()

    def show(self):
        self.fig.show()

    def close(self):
        if self.fig is not None:
            self.plt.close(self.fig)
            self.fig = None

    def is_open(self) -> bool:
        return self.fig is not None and self.plt.fignum_exists(self.fig.number)


__all__ = ['JpegPreviewWindow', 'apply_jpeg_filter']
