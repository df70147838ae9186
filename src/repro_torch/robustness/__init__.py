"""Fault tolerance: keyed fault injection, guarded ticks, quarantine.

``faults`` is the deterministic chaos harness (every fault a pure
function of ``(seed, site, step)``); ``guard.TickGuard`` the serving-side
defence (input admission, poison-lane quarantine, lane restore from a
snapshot).
"""
from repro_torch.robustness.faults import (FAULT_KINDS, IO_FAULTS, SITES,
                                           STATE_FAULTS, TIMING_FAULTS,
                                           TRAFFIC_FAULTS, VALUE_FAULTS,
                                           Fault, FaultInjector, FaultPlan,
                                           PermanentWriteError,
                                           TransientWriteError,
                                           backoff_schedule, corrupt_traffic,
                                           flip_byte, poison_state,
                                           poisoned_values)
from repro_torch.robustness.guard import REJECT_KINDS, TickGuard

__all__ = ["Fault", "FaultPlan", "FaultInjector", "TransientWriteError",
           "PermanentWriteError", "TickGuard", "REJECT_KINDS",
           "backoff_schedule", "corrupt_traffic", "flip_byte",
           "poison_state", "poisoned_values", "FAULT_KINDS", "IO_FAULTS",
           "TRAFFIC_FAULTS", "TIMING_FAULTS", "STATE_FAULTS",
           "VALUE_FAULTS", "SITES"]
