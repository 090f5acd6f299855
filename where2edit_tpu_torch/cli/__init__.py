"""Command-line entry points (counterpart of where2edit_tpu/cli)."""
