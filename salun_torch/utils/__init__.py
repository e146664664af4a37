from .device import resolve_device, seed_all, set_tf32, tf32_settings
from .fanout import run_commands
from .meters import AverageMeter
from .metrics import (MetricsWriter, maybe_profile, span, start_tracing,
                      stop_tracing)

__all__ = ["AverageMeter", "MetricsWriter", "maybe_profile", "resolve_device",
           "run_commands", "seed_all", "set_tf32", "span", "start_tracing",
           "stop_tracing", "tf32_settings"]
