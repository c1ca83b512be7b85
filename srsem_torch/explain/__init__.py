"""Classical image-quality metrics (PSNR, SSIM and their maps)."""
