"""Widget-layout toolkit: measured-text placement for matplotlib UIs
(counterpart of tpu_darktable/scripts/view_raw/ui_builder.py).

Widget axes are sized from rendered text measurements so radio rows and
checkbox panels fit their labels at any figure size: a small vertical-stack
builder plus clean-axes and widget helpers.  Nothing here touches a tensor;
matplotlib is imported where a widget is made.
"""

from __future__ import annotations


def create_clean_axes(fig, rect, *, zorder: int = 10, navigate: bool = False,
                      frame: bool = True):
    """Axes with no ticks, high z-order, optional frame — a widget canvas."""
    ax = fig.add_axes(rect)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_zorder(zorder)
    ax.set_navigate(navigate)
    if not frame:
        ax.axis('off')
    return ax


def measure_text_fractions(fig, labels, fontsize: float = 8.0):
    """Width of each label as a fraction of figure width (rendered metrics,
    with a 15% safety margin; falls back to a char-count estimate when the
    canvas has no renderer, e.g. before the first draw on some backends)."""
    try:
        fig.canvas.draw()
        renderer = fig.canvas.get_renderer()
        fig_w = fig.get_window_extent(renderer=renderer).width
        probe = fig.text(0, 0, '', fontsize=fontsize)
        widths = []
        for label in labels:
            probe.set_text(label)
            widths.append(probe.get_window_extent(renderer=renderer).width / fig_w)
        probe.remove()
        return [w * 1.15 for w in widths]
    except Exception:
        return [len(label) * 0.011 * (fontsize / 8.0) for label in labels]


def fit_fontsize(fig, labels, avail_fraction: float, base: float = 8.0,
                 floor: float = 5.0) -> float:
    """Largest font size (<= base) at which the widest label fits the
    available figure-width fraction."""
    widest = max(measure_text_fractions(fig, labels, base), default=0.0)
    if widest <= 0 or widest <= avail_fraction:
        return base
    return max(floor, base * avail_fraction / widest)


def _measure_axes_fractions(ax, labels, fontsize: float):
    """(label_widths, marker_width, gap) as fractions of the axes width
    (rendered metrics with a 15% margin; char-count fallback without a
    renderer)."""
    fig = ax.get_figure()
    probe = None
    try:
        fig.canvas.draw()
        renderer = fig.canvas.get_renderer()
        bbox = ax.get_window_extent(renderer=renderer)
        if bbox.width <= 0:
            raise ValueError('axes not laid out yet')
        probe = ax.text(0, 0, '', fontsize=fontsize)
        widths = []
        for label in labels:
            probe.set_text(label)
            ext = probe.get_window_extent(renderer=renderer)
            widths.append(ext.width / bbox.width * 1.15)
        probe.set_text('M')
        ext = probe.get_window_extent(renderer=renderer)
        marker_w = ext.width / bbox.width
        gap = ext.height / bbox.height * 0.3
        return widths, marker_w, gap
    except Exception:
        f = fontsize / 8.0
        return [len(label) * 0.08 * f for label in labels], 0.05 * f, 0.015
    finally:
        if probe is not None:
            probe.remove()


def _flow_rows(item_widths, max_width: float, max_rows: int = 2):
    """Pack items into up to `max_rows` centered rows.  Returns a list of
    rows, each a list of (index, x_start); None when even `max_rows` rows
    overflow `max_width` (caller should shrink the font and retry)."""
    for n_rows in range(1, max_rows + 1):
        per = -(-len(item_widths) // n_rows)
        rows = [list(range(i, min(i + per, len(item_widths))))
                for i in range(0, len(item_widths), per)]
        if all(sum(item_widths[i] for i in r) <= max_width for r in rows):
            placed = []
            for r in rows:
                x = (1.0 - sum(item_widths[i] for i in r)) / 2
                row = []
                for i in r:
                    row.append((i, x))
                    x += item_widths[i]
                placed.append(row)
            return placed
    return None


def layout_horizontal_buttons(rb, ax, labels, fontsize: float = 8.0,
                              floor: float = 6.0):
    """Re-lay a RadioButtons/CheckButtons widget horizontally: marker +
    label flow left-to-right, wrapping to a centered second row when one
    row overflows, shrinking the font only as a last resort (the
    reference ui_builder.py:105-206 layout behavior).  No-op when the
    widget's marker collection is not exposed by this matplotlib."""
    markers = getattr(rb, '_buttons', None) or getattr(rb, '_squares', None)
    if markers is None or not hasattr(markers, 'set_offsets'):
        return False
    fs = fontsize
    while True:
        widths, mk, gap = _measure_axes_fractions(ax, labels, fs)
        items = [mk + gap + w + gap for w in widths]
        placed = _flow_rows(items, max_width=0.98)
        if placed is not None or fs <= floor:
            break
        fs = max(floor, fs - 1.0)
    if placed is None:  # overflow even at the floor: keep two rows anyway
        per = -(-len(items) // 2)
        placed = []
        for lo in range(0, len(items), per):
            row, x = [], 0.01
            for i in range(lo, min(lo + per, len(items))):
                row.append((i, x))
                x += items[i]
            placed.append(row)
    ys = [0.5] if len(placed) == 1 else [0.7, 0.3]
    offsets = [None] * len(labels)
    for row, y in zip(placed, ys):
        for i, x in row:
            offsets[i] = (x + mk / 2, y)
            rb.labels[i].set_position((x + mk + gap, y))
            rb.labels[i].set_horizontalalignment('left')
            rb.labels[i].set_verticalalignment('center')
            rb.labels[i].set_fontsize(fs)
    markers.set_offsets(offsets)
    return True


def create_radio_buttons(ax, labels, active_label=None, fontsize: float | None = None,
                         orientation: str = 'vertical'):
    """RadioButtons sized to their labels; returns the widget.
    `orientation='horizontal'` flows marker+label pairs left-to-right with
    a two-row wrap (the reference's panel style)."""
    from matplotlib.widgets import RadioButtons

    if fontsize is None:
        fig = ax.get_figure()
        avail = ax.get_position().width * 0.8
        fontsize = fit_fontsize(fig, labels, avail)
    active = labels.index(active_label) if active_label in labels else 0
    rb = RadioButtons(ax, labels, active=active)
    if orientation == 'horizontal':
        if layout_horizontal_buttons(rb, ax, labels, fontsize):
            return rb
    for text in rb.labels:
        text.set_fontsize(fontsize)
    return rb


def create_checkboxes(ax, labels, actives, fontsize: float | None = None):
    """CheckButtons sized to their labels; returns the widget."""
    from matplotlib.widgets import CheckButtons

    if fontsize is None:
        fig = ax.get_figure()
        avail = ax.get_position().width * 0.8
        fontsize = fit_fontsize(fig, labels, avail)
    cb = CheckButtons(ax, labels, actives)
    for text in cb.labels:
        text.set_fontsize(fontsize)
    return cb


class VStack:
    """Top-down widget column in figure coordinates.

    Each `take(height)` returns the next rect and advances the cursor;
    row heights for label stacks come from `rows(n)` so panels grow with
    their option count instead of being hand-positioned.
    """

    ROW = 0.03  # nominal single-row height (figure fraction)
    GAP = 0.012

    def __init__(self, fig, x: float, top: float, width: float):
        self.fig = fig
        self.x = x
        self.y = top
        self.width = width
        self._left_height = 0.0  # pending half=1 panel height

    def take(self, height: float, *, indent: float = 0.0, width: float | None = None):
        w = self.width - indent if width is None else width
        self.y -= height
        rect = (self.x + indent, self.y, w, height)
        self.y -= self.GAP
        return rect

    def rows(self, n: int) -> float:
        """Height for an n-label widget panel."""
        return max(1, n) * self.ROW

    def slider_ax(self, label_indent: float = 0.05):
        """Axes for one labelled slider row."""
        return self.fig.add_axes(self.take(self.ROW * 0.8, indent=label_indent))

    def panel_ax(self, n_labels: int, *, half: int = 0):
        """Axes for an n-label radio/checkbox panel.  `half`: 0 = full
        width, 1 = left half (does not advance), 2 = right half (advances
        by the taller of the pair)."""
        height = self.rows(n_labels)
        if half == 0:
            return create_clean_axes(self.fig, self.take(height))
        w = self.width / 2
        if half == 1:
            self._left_height = height
            return create_clean_axes(self.fig, (self.x, self.y - height, w, height))
        rect = (self.x + w, self.y - height, w, height)
        self.y -= max(height, self._left_height) + self.GAP
        self._left_height = 0.0
        return create_clean_axes(self.fig, rect)

    def button_row(self, n: int):
        """n equal-width button axes on one row."""
        height = self.ROW
        self.y -= height
        w = self.width / n
        axes = [
            self.fig.add_axes((self.x + i * w, self.y, w, height)) for i in range(n)
        ]
        self.y -= self.GAP
        return axes


__all__ = [
    'VStack',
    'create_checkboxes',
    'create_clean_axes',
    'create_radio_buttons',
    'fit_fontsize',
    'layout_horizontal_buttons',
    'measure_text_fractions',
]
