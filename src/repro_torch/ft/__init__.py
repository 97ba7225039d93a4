# Fault injection of the port (counterpart of repro.ft): the chaos harness
# whose persist.* sites the persistent store fires.
from repro_torch.ft.inject import FaultPlan, FaultSpec, InjectedFault, active_plan, fire, inject

__all__ = ["FaultPlan", "FaultSpec", "InjectedFault", "active_plan", "fire", "inject"]
