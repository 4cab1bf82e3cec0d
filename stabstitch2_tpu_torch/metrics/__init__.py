"""The metric harness: PSNR, SSIM, stability and distortion."""
