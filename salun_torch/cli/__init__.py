"""Command-line entry points: ``python -m salun_torch.cli.main_train``,
``generate_mask``, ``main_random`` and ``main_forget`` (classification);
``python -m salun_torch.cli.ddpm_train`` and
``python -m salun_torch.cli.ddpm_sample`` (DDPM)."""
