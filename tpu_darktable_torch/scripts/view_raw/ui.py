"""Main viewer window: image display + generated settings widgets.

Counterpart of tpu_darktable/scripts/view_raw/ui.py (after the reference's
view_raw/ui.py) - a matplotlib window whose sliders / checkboxes / radio
buttons are generated from the settings' validator metadata (widget
placement via ui_builder.VStack) and reprocess the frame on every change.
The histogram (levels) and JPEG-preview popups are persistent windows that
refresh on navigation and settings changes (histogram_window.py /
jpeg_preview_window.py).  The frame comes from the controller as numpy; the
JPEG encodes run on the controller's device.
Keyboard: left/right = navigate, r = rotate, s = save JPEG, w = write
settings, 0 = reset, h = histogram window, j = JPEG preview window.
"""

from __future__ import annotations

from pathlib import Path

from .pipeline_ui import (
    CHECKBOX_FIELDS,
    SLIDER_FIELDS,
    PipelineController,
    widget_spec,
)
from .histogram_window import HistogramWindow
from .jpeg_preview_window import JpegPreviewWindow
from .jpeg_utils import encode_jpeg_bytes
from .ui_builder import VStack, create_checkboxes, create_radio_buttons


class ProcessRawUI:
    """Interactive viewer (reference ui.py:65-282)."""

    def __init__(self, controller: PipelineController):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button, Slider

        self.c = controller
        self.plt = plt

        self.fig = plt.figure(figsize=(14, 9))
        self.fig.canvas.manager.set_window_title('tpu-darktable raw viewer')
        self.ax_img = self.fig.add_axes([0.02, 0.05, 0.64, 0.9])
        self.ax_img.axis('off')

        col = VStack(self.fig, x=0.70, top=0.95, width=0.26)

        self.sliders = {}
        for field in SLIDER_FIELDS:
            kind, meta = widget_spec(field)
            if kind != 'slider':
                continue
            ax = col.slider_ax()
            lo, hi = meta['range']
            s = Slider(ax, meta['label'], lo, hi,
                       valinit=getattr(self.c.settings, field))
            s.on_changed(self._make_slider_cb(field))
            self.sliders[field] = s

        from ...pipeline.config import Debayer, ToneMapper
        from ...pipeline.presets import presets

        ax = col.panel_ax(len(CHECKBOX_FIELDS), half=1)
        actives = [bool(getattr(self.c.settings, f)) for f in CHECKBOX_FIELDS]
        self.checks = create_checkboxes(ax, CHECKBOX_FIELDS, actives)
        self.checks.on_clicked(self._on_check)

        ax = col.panel_ax(len(Debayer), half=2)
        self.radio_debayer = create_radio_buttons(
            ax, [d.name for d in Debayer], self.c.settings.debayer.name
        )
        self.radio_debayer.on_clicked(self._on_debayer)

        ax = col.panel_ax(len(ToneMapper), half=1)
        self.radio_tm = create_radio_buttons(
            ax, [t.name for t in ToneMapper], self.c.settings.tone_mapping.name
        )
        self.radio_tm.on_clicked(self._on_tonemap)

        ax = col.panel_ax(len(presets), half=2)
        self.radio_preset = create_radio_buttons(ax, list(presets.keys()))
        self.radio_preset.on_clicked(self._on_preset)

        self.buttons = {}
        actions = [
            ('prev', lambda e: self._nav(-1)),
            ('next', lambda e: self._nav(1)),
            ('rotate', lambda e: self._rotate()),
            ('save jpg', lambda e: self._save_jpeg()),
            ('save cfg', lambda e: self._save_settings()),
            ('reset', lambda e: self._reset()),
            ('levels', lambda e: self.show_histogram()),
            ('jpeg', lambda e: self.show_jpeg_preview()),
        ]
        for row_start in range(0, len(actions), 4):
            row = actions[row_start : row_start + 4]
            for ax, (label, cb) in zip(col.button_row(len(row)), row):
                b = Button(ax, label)
                b.on_clicked(cb)
                self.buttons[label] = b

        self.fig.canvas.mpl_connect('key_press_event', self._on_key)
        self._im = None
        self.histogram_window: HistogramWindow | None = None
        self.jpeg_window: JpegPreviewWindow | None = None
        self.refresh()

    # -- callbacks ---------------------------------------------------------
    def _make_slider_cb(self, field):
        def cb(val):
            self.c.update_setting(field, val)
            self.refresh()

        return cb

    def _on_check(self, label):
        self.c.update_setting(label, not getattr(self.c.settings, label))
        self.refresh()

    def _on_debayer(self, label):
        from ...pipeline.config import Debayer

        self.c.update_setting('debayer', Debayer[label])
        self.refresh()

    def _on_tonemap(self, label):
        from ...pipeline.config import ToneMapper

        self.c.update_setting('tone_mapping', ToneMapper[label])
        self.refresh()

    def _on_preset(self, label):
        self.c.apply_preset(label)
        for field, s in self.sliders.items():
            s.set_val(getattr(self.c.settings, field))
        self.refresh()

    def _nav(self, step):
        self.c.next_image(step)
        self.refresh()

    def _rotate(self):
        self.c.rotate()
        self.refresh()

    def _save_jpeg(self):
        img = self.c.process_current()
        out = self.c.current_file.with_suffix('.jpg')
        Path(out).write_bytes(encode_jpeg_bytes(img, quality=94, device=self.c.device))
        print(f'saved {out}')

    def _save_settings(self):
        target = self.c.save_settings()
        print(f'saved settings to {target}')

    def _reset(self):
        self.c.reset()
        for field, s in self.sliders.items():
            s.set_val(getattr(self.c.settings, field))
        self.refresh()

    def _on_key(self, event):
        if event.key == 'left':
            self._nav(-1)
        elif event.key == 'right':
            self._nav(1)
        elif event.key == 'r':
            self._rotate()
        elif event.key == 's':
            self._save_jpeg()
        elif event.key == 'w':
            self._save_settings()
        elif event.key == '0':
            self._reset()
        elif event.key == 'h':
            self.show_histogram()
        elif event.key == 'j':
            self.show_jpeg_preview()

    # -- display + popup windows -------------------------------------------
    def refresh(self):
        img = self.c.process_current()
        if self._im is None or self._im.get_array().shape != img.shape:
            self.ax_img.clear()
            self.ax_img.axis('off')
            self._im = self.ax_img.imshow(img)
        else:
            self._im.set_data(img)
        self.ax_img.set_title(
            f'{self.c.current_file.name}  [{self.c.index + 1}/{len(self.c.raw_files)}]'
        )
        self.fig.canvas.draw_idle()

        # Open popups follow the current frame / settings.
        if self.histogram_window is not None and self.histogram_window.is_open():
            self.histogram_window.update_display(
                self.c.current_bayer(), self.c.camera_settings.bayer_pattern
            )
        if self.jpeg_window is not None and self.jpeg_window.is_open():
            self.jpeg_window.update_display(img)

    def show_histogram(self):
        """Persistent Bayer-levels window (reference histogram_window.py)."""
        if self.histogram_window is not None and self.histogram_window.is_open():
            self.histogram_window.update_display(
                self.c.current_bayer(), self.c.camera_settings.bayer_pattern
            )
        else:
            self.histogram_window = HistogramWindow(
                self.c.current_bayer(), self.c.camera_settings.bayer_pattern
            )
        self.histogram_window.show()

    def show_jpeg_preview(self):
        """Persistent quality explorer with PSNR + size readout
        (reference jpeg_preview_window.py:10-31)."""
        if self.jpeg_window is not None and self.jpeg_window.is_open():
            self.jpeg_window.update_display(self.c.process_current())
        else:
            self.jpeg_window = JpegPreviewWindow(self.c.process_current, device=self.c.device)
        self.jpeg_window.show()

    def run(self):
        self.plt.show()
