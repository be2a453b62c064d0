"""Loss and metric library (port of ``uivr_tpu/opt/losses.py``).

Every reduction is a mean over all elements.  ``l1`` is the optimization
default; PSNR and RMSE are evaluation metrics.
"""
from __future__ import annotations

import torch


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def average(img, ref=None):
    return torch.mean(img)


def l1(img, ref):
    return torch.mean(torch.abs(img - ref))


def l2(img, ref):
    return torch.mean(torch.square(img - ref))


def rmse(img, ref):
    return torch.sqrt(l2(img, ref))


def huber(img, ref, delta: float = 1.0):
    # Bug-compatible with the reference: the branch tests the signed
    # residual ``r < delta``, so large negative residuals are quadratic.
    r = img - ref
    loss = torch.where(r < delta, 0.5 * torch.square(r),
                       delta * torch.abs(r) - 0.5 * delta)
    return torch.mean(loss)


def mean_relative_absolute_error(img, ref, epsilon: float = 1e-2):
    return torch.mean(torch.abs(img - ref) / (torch.abs(ref) + epsilon))


def mean_relative_squared_error(img, ref, epsilon: float = 1e-2):
    return torch.mean(torch.square(img - ref) / (torch.square(ref) + epsilon))


def rmrse(img, ref, epsilon: float = 1e-2):
    return torch.sqrt(mean_relative_squared_error(img, ref, epsilon))


def psnr(img, ref, max_value: float = 1.0):
    mse = torch.mean(torch.square(img - ref))
    return (20.0 * torch.log10(_f32(max_value, mse))
            - 10.0 / torch.log(_f32(10.0, mse)) * torch.log(mse))


LOSSES = {
    "l1": l1, "l2": l2, "rmse": rmse, "huber": huber,
    "mrae": mean_relative_absolute_error, "mrse": mean_relative_squared_error,
    "rmrse": rmrse,
}
