"""Rendering and metric-learning losses and recall (counterpart of
bevrender_tpu/losses): the names that the JAX package's ``losses``
exports."""

from bevrender_tpu_torch.losses.metric import (
    ContrastiveLoss,
    LiftedStructureLoss,
    TripletLossMetricLearning,
    contrastive_loss,
    lifted_structure_loss,
    triplet_loss,
)
from bevrender_tpu_torch.losses.recall import recall_at_k, recall_curve
from bevrender_tpu_torch.losses.rendering import (
    CrossEntropyLoss,
    L1Loss,
    MSELoss,
    cross_entropy_loss,
    l1_loss,
    mse_loss,
)
