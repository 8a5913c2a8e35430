"""Build, load and count the port's CUDA kernels (see :mod:`.build`)."""

from apex_tpu_torch._kernels.build import (
    Kernel,
    build_library,
    launch_counts,
    library,
    reset_launch_counts,
)

__all__ = ["Kernel", "build_library", "launch_counts", "library",
           "reset_launch_counts"]
