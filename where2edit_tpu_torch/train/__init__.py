"""Training of the port (counterpart of where2edit_tpu/train): StyleGAN2
adversarial training, region-attention mapper training and StyleCLIP
latent-mapper training (the coach and its Ranger optimizer), each on one
card."""

from where2edit_tpu_torch.train.coach import Coach, CoachConfig
from where2edit_tpu_torch.train.ranger import Ranger

__all__ = ["Coach", "CoachConfig", "Ranger"]
