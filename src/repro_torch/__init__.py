"""repro_torch — the PyTorch / CUDA port of the ``repro`` package.

It serves the dense GQA family (qwen2-1.5b) through the paged
continuous-batching engine, greedily or at temperature with top-k, and
trains it with LSGD (the deferred update, the two-phase sync on
``torch.distributed``), with hand-written CUDA kernels for paged
attention, view attention, greedy and gumbel-max sampling and the fused
SGD update.  It imports torch and numpy, never jax, and nothing of
``repro``.

  configs       ModelConfig, the registry, smoke_variant
  interop       JAX param pytree / trainer state (flat ``::`` paths) <->
                nested tensors
  tree          nested-dict helpers (tree_map, leaves, unflatten)
  models        layers, attention, transformer, model (build_model), loss
  kernels       CUDA kernels + plain versions + launch counters; prng
  serve         Engine, EngineConfig, scheduler, kv_cache, telemetry
  optim         sgd (SGD/LARS/AdamW), schedules
  core          topology, virtual Algorithms 1-3, sync, trainer
  data          synthetic token stream, HostLoader
  launch        train (``python -m repro_torch.launch.train``),
                profile_train
"""
