"""repro_torch.serve — continuous-batching inference on the port's paged
model interface (``Model.init_paged_cache`` / ``paged_step`` /
``paged_decode_loop``).

  engine       Engine: one fused mixed prefill+decode call per step, or
               N decode steps per dispatch on the device; depth-1
               pipelined dispatch; sampling on the device; request
               deadlines, post-mortem reclaim, per-request progress; its
               own CUDA stream
  kv_cache     block pool allocator + per-sequence block tables
  scheduler    FCFS policy with a prefill-token budget; RequestQueue
  router       token-weighted replica placement over Topology axes
  dispatcher   ServeCluster: one Engine per device slice + worker
               threads; the slow layer carries only admission, results,
               health and metrics
  faults       replica lifecycle states, health/retry policy,
               deterministic fault-injection plans
  telemetry    metrics registry, request lifecycle traces, span timelines
"""
from repro_torch.serve.dispatcher import ServeCluster
from repro_torch.serve.engine import Engine, EngineConfig, RequestResult
from repro_torch.serve.faults import (FaultAction, FaultInjected, FaultPlan,
                                      HealthConfig, NoLiveReplicas,
                                      Overloaded, ReplicaKilled,
                                      ReplicaState, RetryPolicy)
from repro_torch.serve.router import Replica, ReplicaRouter
from repro_torch.serve.scheduler import Request, RequestQueue
from repro_torch.serve.telemetry import Telemetry

__all__ = ["Engine", "EngineConfig", "FaultAction", "FaultInjected",
           "FaultPlan", "HealthConfig", "NoLiveReplicas", "Overloaded",
           "Replica", "ReplicaKilled", "ReplicaRouter", "ReplicaState",
           "Request", "RequestQueue", "RequestResult", "RetryPolicy",
           "ServeCluster", "Telemetry"]
