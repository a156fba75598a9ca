"""Utilities: metrics and observability (the counterpart of
``specenh.utils``)."""

from specenh_torch.utils.logging import MetricsLogger, SpanTimer, nan_guard, profile_trace, span  # noqa: F401
from specenh_torch.utils.metrics import psnr, ssim  # noqa: F401
