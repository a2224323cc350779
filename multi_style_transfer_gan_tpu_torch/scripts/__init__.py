"""The trained-model study on the card (the counterparts of the JAX repo's
``scripts/`` of the same names; ``docs/TRAINED_STUDY.md`` "Recipe"):

- ``make_synthetic_domains``   the synthetic unpaired domains (host)
- ``select_checkpoints``       validation-SSIM selection and the soup export
- ``make_sample_grids``        input | output | truth sample grids
- ``run_trained_surface``      every user-facing surface on the selection
- ``reproduce_quality_study``  the reference's 54-image quality study

Each runs as ``python -m multi_style_transfer_gan_tpu_torch.scripts.<name>``
with the JAX script's flags.
"""
