"""The persistent executable store (the port's copy of
``video_features_tpu/aot/``): a second process loads the compiled code a
first one published, instead of compiling it again.

In the port the compiled code is the CUDA kernel libraries, the ``.so``
files ``nvcc`` builds from ``csrc/<name>.cu`` (``ops/_kernels.py``);
everything else the port runs is eager PyTorch over precompiled cuDNN
and cuBLAS. CUDA graphs cannot be written to disk, and a
``torch.compile`` artifact would compute other bytes than the eager
path, so neither is stored. A loaded library is the built library's
exact bytes, which is why the ``aot_*`` knobs stay out of the run
fingerprint.

Two layers:

  * :mod:`aot.store`: the torch-free byte store (atomic writes,
    integrity checks that evict corrupt entries instead of serving them,
    size-bounded LRU GC), the JAX package's store;
  * :mod:`aot.runtime`: ``ensure_library``, the one path that loads a
    library from the store or builds and publishes it, keyed on the
    library's identity (source, ``NVCC_FLAGS``, nvcc release) and the
    runtime environment (torch, CUDA, device kind, capability, host
    ISA). A changed component is a silent miss: the library builds and
    publishes under its own key, and a structured event names the drift.

``aot/gc.py`` (``python -m video_features_torch aot-gc``) is the offline
GC; ``fleet/artifacts.py`` puts a shared tier behind the store.
"""
from video_features_torch.aot.store import (  # noqa: F401
    ExecStore, log_aot_error, merge_exec_stats,
)
