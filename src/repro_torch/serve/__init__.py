"""repro_torch.serve — continuous-batching inference on the port's paged
model interface (``Model.init_paged_cache`` / ``paged_step`` /
``paged_decode_loop``).

  engine       Engine: one fused mixed prefill+decode call per step, or
               N decode steps per dispatch on the device; depth-1
               pipelined dispatch; greedy sampling on the device
  kv_cache     block pool allocator + per-sequence block tables
  scheduler    FCFS policy with a prefill-token budget; RequestQueue
  telemetry    metrics registry, request lifecycle traces, span timelines

The cluster layer (router, dispatcher, faults) is not ported yet.
"""
from repro_torch.serve.engine import Engine, EngineConfig, RequestResult
from repro_torch.serve.scheduler import Request, RequestQueue
from repro_torch.serve.telemetry import Telemetry

__all__ = ["Engine", "EngineConfig", "Request", "RequestQueue",
           "RequestResult", "Telemetry"]
