"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter (``<wrapper>.launches``).

  flash_decode.flash_decode_paged   paged decode / prefill-chunk attention
  flash_decode.flash_decode         one-token decode over a contiguous
                                    cache (the non-paged decode_step)
  flash_attention.flash_attention   full-sequence flash attention (the
                                    non-paged prefill)
  decode_view.decode_view_attend    N-step loop's view attention
  sampling.greedy_sample            per-row argmax
  sampling.gumbel_sample            temperature / top-k gumbel-max
  fused_update.fused_sgd_update     SGD-momentum (+ LARS) update
  slot_state.slot_gather            recurrent-state rows out of a slot pool
  slot_state.slot_scatter           recurrent-state rows back into it
  ssd_chunk.ssd_chunk_bchp          Mamba-2 SSD intra-chunk block
  mla_decode.mla_decode_views       N-step loop's absorbed MLA attention
                                    over per-row latent views
  mla_decode.mla_decode_paged       fused step's absorbed MLA attention
                                    over latent block pools

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built on first use by ``_build``) or raises.
``prng`` (the reference's threefry draws) is plain PyTorch.
"""
from repro_torch.kernels.decode_view import decode_view_attend
# the modules flash_attention and flash_decode keep their names here
# (callers import them as modules); their same-named wrappers are
# reached through them
from repro_torch.kernels import flash_attention, flash_decode
from repro_torch.kernels.flash_decode import flash_decode_paged
from repro_torch.kernels.fused_update import fused_sgd_update
from repro_torch.kernels.mla_decode import mla_decode_paged, mla_decode_views
from repro_torch.kernels.sampling import greedy_sample, gumbel_sample
from repro_torch.kernels.slot_state import slot_gather, slot_scatter
from repro_torch.kernels.ssd_chunk import ssd_chunk_bchp

KERNELS = (flash_decode_paged, decode_view_attend, greedy_sample,
           gumbel_sample, fused_sgd_update, slot_gather, slot_scatter,
           ssd_chunk_bchp, mla_decode_views, mla_decode_paged,
           flash_attention.flash_attention, flash_decode.flash_decode)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["KERNELS", "decode_view_attend", "flash_attention",
           "flash_decode", "flash_decode_paged",
           "fused_sgd_update", "greedy_sample", "gumbel_sample",
           "launch_counts", "mla_decode_paged", "mla_decode_views",
           "reset_launch_counts", "slot_gather",
           "slot_scatter", "ssd_chunk_bchp"]
