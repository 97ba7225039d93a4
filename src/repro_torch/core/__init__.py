# The engine of the port (counterpart of repro.core): semirings, schedules on
# a torch device, the plain round, the host loop, and the δ cost model.
