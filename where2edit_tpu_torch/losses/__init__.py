"""Training losses of the region-attention trainer (counterparts of
where2edit_tpu/losses): CLIP image features, the VGG perceptual loss and
the InfoNCE consistency loss."""
