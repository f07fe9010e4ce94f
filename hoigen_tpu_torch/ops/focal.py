"""Focal loss and the prior-modulated logit transform (port of
``hoigen_tpu/ops/focal.py``)."""
import torch


def _bce_with_logits(x, y):
    # numerically stable BCE-with-logits: max(x,0) - x*y + log1p(exp(-|x|))
    return x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))


def binary_focal_loss_with_logits(x, y, alpha: float = 0.5,
                                  gamma: float = 2.0, reduction: str = "mean",
                                  eps: float = 1e-6, weights=None):
    """L = |1-y-alpha| * (|y-sigmoid(x)| + eps)^gamma * BCEwithLogits(x, y).

    ``weights`` (optional, same shape) masks entries before reduction."""
    loss = ((1.0 - y - alpha).abs()
            * ((y - torch.sigmoid(x)).abs() + eps) ** gamma
            * _bce_with_logits(x, y))
    if weights is not None:
        loss = loss * weights
    if reduction == "mean":
        return loss.mean() if weights is None else loss.sum() / weights.sum()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"Unsupported reduction {reduction}")


def prior_modulated_logits(logits, prior, eps: float = 1e-8):
    """log(prior / (1 + e^-logits - prior) + eps). Entries with prior == 0
    are excluded from the loss by the caller's weight mask; the value only
    has to stay finite there."""
    return torch.log(prior / (1.0 + torch.exp(-logits) - prior) + eps)
