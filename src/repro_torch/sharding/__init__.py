from repro_torch.sharding.rules import (
    batch_pspecs,
    cache_pspecs,
    distribute,
    logits_pspec,
    named,
    param_pspecs,
)

__all__ = ["param_pspecs", "batch_pspecs", "cache_pspecs", "logits_pspec", "named",
           "distribute"]
