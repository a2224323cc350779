"""Measuring tools of the port that run on the card (``python -m
multi_style_transfer_gan_tpu_torch.tools.<name>``)."""
