"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter (``<wrapper>.launches``).

  flash_decode.flash_decode_paged   paged decode / prefill-chunk attention
  decode_view.decode_view_attend    N-step loop's view attention
  sampling.greedy_sample            per-row argmax
  sampling.gumbel_sample            temperature / top-k gumbel-max
  fused_update.fused_sgd_update     SGD-momentum (+ LARS) update

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built on first use by ``_build``) or raises.
``prng`` (the reference's threefry draws) is plain PyTorch.
"""
from repro_torch.kernels.decode_view import decode_view_attend
from repro_torch.kernels.flash_decode import flash_decode_paged
from repro_torch.kernels.fused_update import fused_sgd_update
from repro_torch.kernels.sampling import greedy_sample, gumbel_sample

KERNELS = (flash_decode_paged, decode_view_attend, greedy_sample,
           gumbel_sample, fused_sgd_update)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["KERNELS", "decode_view_attend", "flash_decode_paged",
           "fused_sgd_update", "greedy_sample", "gumbel_sample",
           "launch_counts", "reset_launch_counts"]
