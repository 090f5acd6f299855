"""Evaluation (counterpart of where2edit_tpu/eval): FID / IS statistics,
the edit-quality sweep, SSIM and the attention maps' mIoU."""

from where2edit_tpu_torch.eval.iou import attention_with_text, remap_celeba_labels
from where2edit_tpu_torch.eval.metrics import (
    EditEvaluator,
    frechet_distance,
    inception_score_from_probs,
)

__all__ = ["frechet_distance", "inception_score_from_probs", "EditEvaluator",
           "attention_with_text", "remap_celeba_labels"]
