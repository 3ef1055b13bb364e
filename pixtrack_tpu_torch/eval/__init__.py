"""Evaluation: ADD / ADD-S metrics, trajectory alignment, threshold curves."""

from pixtrack_tpu_torch.eval.metrics import (
    add_error,
    add_s_error,
    umeyama_alignment,
    pose_errors,
    threshold_accuracy,
    auc_of_threshold_curve,
    evaluate_trajectory,
)

__all__ = [
    "add_error",
    "add_s_error",
    "umeyama_alignment",
    "pose_errors",
    "threshold_accuracy",
    "auc_of_threshold_curve",
    "evaluate_trajectory",
]
