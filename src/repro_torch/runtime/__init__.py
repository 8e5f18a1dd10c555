"""The port's runtime: the straggler watchdog and the in-process fault
injectors of the resilient ``fit``."""
from repro_torch.runtime.straggler import StepTimeMonitor  # noqa: F401
