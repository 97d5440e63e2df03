"""Forecasting losses (paper Eq. (5)), in f32 whatever the inputs' dtype."""

from __future__ import annotations

import torch


def mse(pred, target) -> torch.Tensor:
    """Paper Eq. (5): mean squared forecasting error."""
    return torch.mean(torch.square(pred.float() - target.float()))


def mae(pred, target) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))
