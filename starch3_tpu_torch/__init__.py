"""starch3-tpu-torch: the Starch codec's device path on PyTorch and CUDA.

A port of the JAX package ``starch3_tpu`` to an NVIDIA H100.  It imports
``torch`` and never ``jax``, and nothing of ``starch3_tpu``: it stands
alone.  Its host tier is a copy of the JAX package's, with the package
prefix of the imports rewritten and nothing else changed, so the two
write the same bytes (``tests/test_torch_isolation.py`` holds the copies
to their originals): ``codec/``, ``bed/``, ``format/``, ``transform/``,
``config``, ``errors``, ``_version``, ``parallel/assemble.py`` and
``runtime/`` (the same ``runtime.cpp``, built into ``build/``).  Module names mirror the JAX
package:

  - ``ops.bwt_fast``:   one-sort BWTs of every alphabet tier, batched, in
                        torch ops
  - ``ops.bwt``:        the exact prefix-doubling BWT of the legacy exact
                        modes (``fast_bwt=False``), batched, in torch ops
  - ``ops.mtf_narrow``: narrow-alphabet MTF (widths 16/32/64); a
                        hand-written CUDA kernel (``csrc/mtf_narrow.cu``)
                        on a CUDA device
  - ``ops.mtf_wide``:   wide-alphabet MTF (widths 128/256); a hand-written
                        CUDA kernel (``csrc/mtf_wide.cu``) on a CUDA device
  - ``ops.rle2``:       zero-run coding of MTF ranks, batched, in torch ops
  - ``ops.transform``:  the delta transform's scan formulation (encode
                        core, decode prefix sum, decimal lengths, union
                        length), in torch ops
  - ``ops.irle2``, ``ops.imtf``, ``ops.ibwt``: the decode side's inverse
                        RLE2, MTF and BWT, batched, in torch ops
  - ``parallel.pipeline``: the device steps of the bits 4, 5/6 and 8
                        tiers and of the exact modes, dispatch, drain and
                        driver; the decode step and ``decode_streams``
  - ``parallel.host``:  the host scheduler, tail and stream assembly,
                        copied from ``starch3_tpu/parallel/pipeline.py``
  - ``parallel.mesh``:  block meshes over torch devices (data parallelism
                        over blocks: each entry runs the step on its slice
                        of every batch, on its own CUDA stream)
  - ``parallel.distributed``: multi-host encode over a gloo process group
                        (``torch.distributed``) or a manifest directory
  - ``parallel.assemble``: the manifest and ordered archive assembly,
                        copied from the JAX package
  - ``api``, ``cli``:   entry points with an explicit torch ``device``;
                        their host parts are copies of the JAX package's
  - ``observability``:  ``StageTimer`` (each stage a ``torch.profiler``
                        range) and ``device_trace``, a ``torch.profiler``
                        trace of the host and the card

The device is always explicit (``"cuda"`` by default, ``"cpu"`` for the
plain PyTorch versions); nothing falls back from the card to the CPU.
Every public name of the JAX package has its counterpart here
(``tests/test_torch_parity.py`` holds the table).
"""

from starch3_tpu_torch._version import __version__

__all__ = ["__version__"]
