"""Utilities: metrics and observability (the counterpart of
``specenh.utils``)."""

from specenh_torch.utils.logging import (  # noqa: F401
    MetricsLogger, SpanRecorder, nan_guard, profile_trace, recording, span)
from specenh_torch.utils.metrics import psnr, ssim  # noqa: F401
