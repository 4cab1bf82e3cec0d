"""PSNR and SSIM with scikit-image 0.15's formulas (port of
``metrics/psnr_ssim.py``).

The reference scores with skimage 0.15's ``compare_psnr`` and
``compare_ssim`` (multichannel, data_range 255):
- PSNR: 10 * log10(data_range^2 / mse) over the whole image;
- SSIM: a 7x7 uniform window, the sample covariance (N / (N - 1)),
  C1 = (0.01 L)^2, C2 = (0.03 L)^2, the map's (win - 1) // 2 border
  cropped, channel-averaged. Averaging over the valid windows is that crop.
"""

from __future__ import annotations

import torch


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """[..., H, W, C] pair -> scalar PSNR in dB."""
    mse = torch.mean((img1.float() - img2.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over win x win windows of x [H, W], valid region only.

    Separable sums of shifted slices, not an integral image: a float32
    double cumulative sum of x*x reaches ~1e10 at 360x480 and its
    four-corner differences would cancel to garbage in flat regions.
    """
    H, W = x.shape
    rows = sum(x[i:H - win + 1 + i] for i in range(win))
    cols = sum(rows[:, j:W - win + 1 + j] for j in range(win))
    return cols / (win * win)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7) -> torch.Tensor:
    """Channel-averaged SSIM of [H, W, C] (or [H, W]) images: a scalar."""
    if img1.dim() == 2:
        img1, img2 = img1[..., None], img2[..., None]
    x, y = img1.float(), img2.float()
    NP = win_size * win_size
    cov_norm = NP / (NP - 1.0)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2

    def channel(xc, yc):
        ux = _uniform_filter_valid(xc, win_size)
        uy = _uniform_filter_valid(yc, win_size)
        uxx = _uniform_filter_valid(xc * xc, win_size)
        uyy = _uniform_filter_valid(yc * yc, win_size)
        uxy = _uniform_filter_valid(xc * yc, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        A1 = 2.0 * ux * uy + C1
        A2 = 2.0 * vxy + C2
        B1 = ux * ux + uy * uy + C1
        B2 = vx + vy + C2
        return torch.mean(A1 * A2 / (B1 * B2))

    return torch.mean(torch.stack([channel(x[..., c], y[..., c])
                                   for c in range(x.shape[-1])]))
