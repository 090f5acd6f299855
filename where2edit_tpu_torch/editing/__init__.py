"""Region-attention editing (counterpart of where2edit_tpu/editing)."""
