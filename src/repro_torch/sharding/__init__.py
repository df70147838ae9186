"""Mesh-axis sharding rules for params, batches and caches."""
from repro_torch.sharding.rules import (Placement, Rules, batch_pspecs,
                                        cache_pspecs, device_bytes, dp_axes,
                                        named, param_pspecs)

__all__ = ["Rules", "param_pspecs", "batch_pspecs", "cache_pspecs", "named",
           "dp_axes", "Placement", "device_bytes"]
