"""Image operations of the port; each module mirrors its JAX counterpart in
tpu_darktable/ops/."""
