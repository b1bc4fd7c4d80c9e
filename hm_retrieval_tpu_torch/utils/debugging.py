"""Numeric-debug mode: trap the first NaN at the operation that makes it.

Counterpart of the JAX package's ``utils/debugging.py``, whose
``jax_debug_nans`` raises ``FloatingPointError`` at the op that produced a
NaN, in forward and in backward. Here ``enable_debug_checks`` pushes a
``TorchDispatchMode`` that looks at every floating output of every aten op
(autograd's backward ops included: the engine carries the mode to its
device threads) and raises ``FloatingPointError`` naming the op. The mode
sees aten ops only, not the CUDA kernels that ``ops/bin_topk.py`` and
``ops/quantized_topk.py`` launch through ``ctypes``, so those wrappers call
``check_outputs`` on what they return, as JAX checks a ``pallas_call``'s
outputs. Every check copies one flag to the host and so synchronises the
card; enable for test and debug runs only.

The port has no jit, ``torch.compile`` or CUDA graph on any path: it runs op
by op already, so ``disable_jit=True`` is accepted and only logged.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

logger = logging.getLogger(__name__)

# ops whose outputs are uninitialised memory until something writes them
_UNINITIALISED = {
    torch.ops.aten.empty,
    torch.ops.aten.empty_like,
    torch.ops.aten.empty_strided,
    torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided,
    torch.ops.aten.resize_,
}


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.device.type != "meta" and t.numel() > 0
            and bool(torch.isnan(t).any()))


class _NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` where an op's floating output holds a
    NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in _UNINITIALISED and any(
                map(_has_nan, tree_leaves(out))):
            raise FloatingPointError(f"NaN in the output of {func}")
        return out


_mode: Optional[_NanCheck] = None


def enable_debug_checks(nans: bool = True, disable_jit: bool = False):
    """Trap NaNs at the op that makes them (``nans``); ``disable_jit`` is
    accepted for the JAX package's signature and only logged."""
    global _mode
    if nans and _mode is None:
        _mode = _NanCheck()
        _mode.__enter__()
        logger.info("NaN checks enabled on every op")
    if disable_jit:
        logger.info("disable_jit: the port has no jit; it runs op by op "
                    "already")


def disable_debug_checks():
    """Pop the NaN checks: nothing is checked and nothing syncs after it."""
    global _mode
    if _mode is not None:
        mode, _mode = _mode, None
        mode.__exit__(None, None, None)


def check_outputs(name: str, outputs: Iterable[torch.Tensor]):
    """While the checks are on, raise ``FloatingPointError`` naming the
    kernel ``name`` if a floating output holds a NaN; returns ``outputs``
    as given. Does nothing, and syncs nothing, while they are off."""
    if _mode is not None and any(map(_has_nan, outputs)):
        raise FloatingPointError(f"NaN in the output of kernel {name}")
    return outputs
