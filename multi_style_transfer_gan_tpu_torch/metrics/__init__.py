"""Evaluation metrics (SSIM/PSNR/MSE/FID) and reporting."""

from .fid import fid_from_features, frechet_distance
from .quality import compare_pair, mse, psnr, ssim

__all__ = ["compare_pair", "fid_from_features", "frechet_distance", "mse",
           "psnr", "ssim"]
