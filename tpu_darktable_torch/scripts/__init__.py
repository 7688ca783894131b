"""Command-line tools of the port (counterparts of tpu_darktable/scripts/).

Each image tool has a pure function on tensors, `run(rgb, args, device)`,
beside its `main()`, which reads and writes the files.  Every tool takes
`--device` (default `cuda`); pass `--device cpu` to run the plain versions
on the CPU.  Pillow and matplotlib are imported only where a file is read,
written or shown.
"""
