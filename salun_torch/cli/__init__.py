"""Command-line drivers: ``python -m salun_torch.cli.generate_mask`` and
``python -m salun_torch.cli.main_random`` (classification);
``python -m salun_torch.cli.ddpm_train`` and
``python -m salun_torch.cli.ddpm_sample`` (DDPM)."""
