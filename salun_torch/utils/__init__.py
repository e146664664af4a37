from .device import resolve_device, seed_all, set_tf32, tf32_settings

__all__ = ["resolve_device", "seed_all", "set_tf32", "tf32_settings"]
