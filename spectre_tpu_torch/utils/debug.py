"""Debugging and determinism switches (port of spectre_tpu/utils/debug.py).

- ``enable_nan_checks``: the JAX package's ``jax_debug_nans`` stops at the
  primitive that produced a NaN. Here a global module forward hook checks
  every module's output and raises, naming the first module (innermost
  first, by its path from the outermost module running) whose output is not
  finite; ``torch.autograd.set_detect_anomaly`` covers the backward. The
  kernels launch through ctypes, beside the dispatcher, so a dispatch-level
  mode would not see them; a module's output it does. The hook reads each
  output on the host: a debugging mode, not one to train in.
- ``deterministic_mode``: what the JAX function does and no more, the float32
  matmul precision pinned to "highest": TF32 off for cuBLAS and cuDNN.
  ``on=False`` restores the state found when it was turned on.
  (``torch.use_deterministic_algorithms`` would be more than JAX does, and
  would demand ``CUBLAS_WORKSPACE_CONFIG`` before the first cuBLAS handle.)
- ``check_finite``: one 0-d bool tensor on the tensors' device, True when
  every leaf is finite, without a host sync (a train step under
  ``torch.cuda.set_sync_debug_mode("error")`` may call it). The paths of the
  non-finite leaves are printed when the caller reads the result on the host
  (``bool()`` or ``.item()``).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

# the handles of the hooks enable_nan_checks registered, and the TF32 state
# deterministic_mode found: the process-wide switches these toggle are
# process-wide themselves
_nan_hooks: list = []
_saved_precision: list = []


def _module_path(stack: list) -> str:
    """``Outer.child.grandchild`` for the modules running, outermost first."""
    parts = [type(stack[0]).__name__]
    for parent, child in zip(stack, stack[1:]):
        parts.append(next((n for n, m in parent.named_children() if m is child),
                          type(child).__name__))
    return ".".join(parts)


def enable_nan_checks(on: bool = True) -> None:
    """Raise ``FloatingPointError`` naming the first module whose output holds
    a NaN or an infinity, and turn on autograd's anomaly detection; ``False``
    removes both."""
    for handle in _nan_hooks:
        handle.remove()
    _nan_hooks.clear()
    torch.autograd.set_detect_anomaly(on)
    if not on:
        return
    stack: list = []

    def pre_hook(module, args):
        # drop modules a raised forward left behind: the stack holds the
        # chain of parents of the module now starting
        while stack and not any(m is module for m in stack[-1].children()):
            stack.pop()
        stack.append(module)

    def post_hook(module, args, output):
        path = _module_path(stack) if stack and stack[-1] is module else type(module).__name__
        if stack and stack[-1] is module:
            stack.pop()
        for leaf in pytree.tree_leaves(output):
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and not bool(torch.isfinite(leaf).all())):
                stack.clear()
                raise FloatingPointError(f"non-finite output of module {path}")

    _nan_hooks.append(torch.nn.modules.module.register_module_forward_pre_hook(pre_hook))
    _nan_hooks.append(torch.nn.modules.module.register_module_forward_hook(post_hook))


def deterministic_mode(on: bool = True) -> None:
    """Pin float32 matmuls to full float32 precision (no TF32 in cuBLAS or
    cuDNN); ``False`` restores what ``True`` found."""
    if on:
        if not _saved_precision:
            _saved_precision.append((torch.get_float32_matmul_precision(),
                                     torch.backends.cuda.matmul.allow_tf32,
                                     torch.backends.cudnn.allow_tf32))
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif _saved_precision:
        precision, matmul_tf32, cudnn_tf32 = _saved_precision.pop()
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


class FiniteCheck(torch.Tensor):
    """The 0-d bool result of ``check_finite``: a tensor whose ``bool()`` and
    ``item()`` print the paths of the non-finite leaves before answering.
    Operations on it give plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def _report(self) -> None:
        for label, ok in zip(self.labels, self.flags.tolist()):
            if not ok:
                print("NON-FINITE values in " + label, flush=True)

    def __bool__(self) -> bool:
        ok = torch.Tensor.item(self)
        if not ok:
            self._report()
        return bool(ok)

    def item(self):
        return self.__bool__()


def check_finite(tree, name: str = "tree") -> torch.Tensor:
    """True (a 0-d bool tensor on the first leaf's device) when every tensor
    leaf of ``tree`` is finite; no host sync until the caller reads it."""
    leaves = [(f"{name}{pytree.keystr(path)}", leaf)
              for path, leaf in pytree.tree_flatten_with_path(tree)[0]
              if isinstance(leaf, torch.Tensor)]
    if not leaves:
        return torch.tensor(True)
    device = leaves[0][1].device
    flags = torch.stack([torch.isfinite(leaf).all().to(device) for _, leaf in leaves])
    result = torch.Tensor._make_subclass(FiniteCheck, flags.all())
    result.labels, result.flags = [label for label, _ in leaves], flags
    return result
