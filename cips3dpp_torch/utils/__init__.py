"""Mesh extraction, the software rasterizer, logging, and the inversion
report's metrics (LPIPS, PSNR, SSIM)."""
