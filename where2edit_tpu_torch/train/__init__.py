"""Training of the port (counterpart of where2edit_tpu/train): StyleGAN2
adversarial training and region-attention mapper training, each on one
card."""
