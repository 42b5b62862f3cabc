"""Deterministic fault injection and recovery (the chaos harness;
``repro.faults`` on torch, pure host code).

``FaultPlan`` composes seeded injectors (registered in ``INJECTORS``) that
fire at well-defined sites in the store, session, and service layers; every
firing and every downstream recovery decision lands in a ``FaultLedger``
whose ``signature()`` is reproducible bit-for-bit from the plan seed — and
equal to the reference's for the same plan and workload.
"""
from repro_torch.faults.events import (DegradedModeEvent, DeviceFault,
                                       FaultError, FaultEvent, FaultLedger,
                                       InjectedCrash, JobHang, RecoveryEvent,
                                       TransientJobError)
from repro_torch.faults.plan import (INJECTORS, FaultInjector, FaultPlan,
                                     chaos_plan, make_injector,
                                     register_injector)

__all__ = [
    "DegradedModeEvent", "DeviceFault", "FaultError", "FaultEvent",
    "FaultLedger", "InjectedCrash", "JobHang", "RecoveryEvent",
    "TransientJobError",
    "INJECTORS", "FaultInjector", "FaultPlan", "chaos_plan",
    "make_injector", "register_injector",
]
