"""Command-line entry points of the port, one module each, run as
`python3 -m asva_tpu_torch.scripts.<name>`: counterparts of the repository's
scripts/<name>.py with the same flags and outputs, plus `--device`."""
