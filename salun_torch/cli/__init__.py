"""Command-line drivers: ``python -m salun_torch.cli.generate_mask`` and
``python -m salun_torch.cli.main_random``."""
