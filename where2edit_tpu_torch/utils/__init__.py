"""Host-side utilities of the port (counterparts of where2edit_tpu/utils):
the native k-means runtime, image grids, run logging and seeding."""
