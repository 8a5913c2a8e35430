"""apex_tpu_torch.data — host-side input pipelines with device prefetch.

Twin of ``apex_tpu.data``: :func:`synthetic_loader`, :func:`npz_loader`,
:func:`image_folder_loader`, :func:`s2d_batches` and
:func:`prefetch_to_device` (see :mod:`.loaders`).
"""

from apex_tpu_torch.data.loaders import (
    image_folder_loader,
    npz_loader,
    prefetch_to_device,
    s2d_batches,
    synthetic_loader,
)

__all__ = ["image_folder_loader", "npz_loader", "prefetch_to_device",
           "s2d_batches", "synthetic_loader"]
