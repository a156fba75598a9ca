"""OpenCV fixed-point kernel extraction by impulse probing.

OpenCV's CV_8U Gaussian blur is bit-exact fixed-point (Q8.8 kernels with an
error-diffusion quantiser whose exact tap values are not reproducible from
the float formula — e.g. the 31-tap kernel is non-monotonic at taps +-13/14).
Rather than re-implement OpenCV's softdouble quantiser, this tool recovers
the EFFECTIVE integer taps from any OpenCV build by probing with impulse
images and inverting the rounding model:

    observed(a) = (a * K + 128) >> 8      for a separable 1-D pass

Each tap's integer K is uniquely determined by the observations over
amplitudes 1..255.  The shipped tables in specenh_torch.ops.enhance were produced
this way against cv2 5.0 and verified bit-identical on random images; run
``python -m specenh_torch.utils.cv_probe 31`` to re-derive them against another
OpenCV build.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

__all__ = ["probe_gaussian_q88"]


def probe_gaussian_q88(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """Extract the Q8.8 taps of ``cv2.GaussianBlur(src, (ksize, 1), sigma)``
    on CV_8U input.  Requires cv2."""
    import cv2

    half = ksize // 2
    w = 2 * ksize + 2
    src = np.zeros((255, w), np.uint8)
    centre = w // 2
    for a in range(1, 256):
        src[a - 1, centre] = a
    out = cv2.GaussianBlur(src, (ksize, 1), sigma)

    taps: List[int] = []
    for d in range(-half, half + 1):
        col = out[:, centre + d].astype(np.int64)
        cands = [
            k
            for k in range(257)
            if all(((a * k + 128) >> 8) == col[a - 1] for a in range(1, 256))
        ]
        if len(cands) != 1:
            raise RuntimeError(
                f"tap {d}: rounding model mismatch (candidates {cands}) — "
                "this OpenCV build uses a different fixed-point scheme"
            )
        taps.append(cands[0])
    arr = np.asarray(taps, np.int64)
    if arr.sum() != 256:
        raise RuntimeError(f"taps sum to {arr.sum()} != 256; probe invalid")
    return arr


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    for ks in [int(a) for a in args] or [31, 3]:
        taps = probe_gaussian_q88(ks)
        print(f"ksize={ks}: {taps.tolist()}")


if __name__ == "__main__":
    main()
