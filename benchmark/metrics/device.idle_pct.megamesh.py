"""The share of the traced window in which no kernel, copy or memset ran
on the device (torch.profiler, CPU and CUDA activities)."""
from readers import idle_pct as read  # noqa: F401
