"""The edit API and session construction (counterpart of where2edit_tpu/demo)."""
