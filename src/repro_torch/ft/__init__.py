# Fault tolerance of the port (counterpart of repro.ft): the chaos harness
# (inject), the degradation ladder (degrade) and checkpointed solves
# (elastic, imported on its own: it needs the solver's modules).
from repro_torch.ft.inject import FaultPlan, FaultSpec, InjectedFault, active_plan, fire, inject

__all__ = ["FaultPlan", "FaultSpec", "InjectedFault", "active_plan", "fire", "inject"]
