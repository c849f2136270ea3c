"""repro_torch — the PyTorch / CUDA port of the ``repro`` package.

Slice 1 serves the dense GQA family (qwen2-1.5b) through the paged
continuous-batching engine, greedily, with hand-written CUDA kernels for
paged attention, view attention and greedy sampling.  It imports torch
and numpy, never jax, and nothing of ``repro``.

  configs       ModelConfig, the registry, smoke_variant
  interop       JAX param pytree (flat ``::`` paths) <-> nested tensors
  models        layers, attention, transformer, model (build_model)
  kernels       CUDA kernels + plain versions + launch counters
  serve         Engine, EngineConfig, scheduler, kv_cache, telemetry
"""
