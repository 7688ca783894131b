"""Interactive raw-file viewer and tuner (counterpart of
tpu_darktable/scripts/view_raw/).  The controller (pipeline_ui.py) and the
JPEG helpers run without matplotlib or Pillow; the windows import
matplotlib when they open."""
