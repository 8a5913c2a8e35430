"""The pre-O1 original of a possibly patched torch function.

Twin of ``apex_tpu/ops/pallas_utils.py::unpatched``.  ``amp.patch``
installs precision wrappers on the ``torch`` namespaces (the O1 op
policy), each keeping the function it wraps as ``__amp_original__``.
Plain versions that upcast to fp32 on purpose (the flash and decode
attention references) call through :func:`unpatched`, so an active O1
policy cannot cast their fp32 operands down to half: the twin of the
reference keeping raw function handles (``apex/amp/utils.py:131-158``).
"""


def unpatched(fn):
    """``fn``'s original under an O1 patch, else ``fn``."""
    return getattr(fn, "__amp_original__", fn)
