# -*- coding: utf-8 -*-
"""Gradients through the kernels: the base of the port's counterparts of
the JAX package's custom VJPs (`ssqueezepy_tpu/ops/cwt_pallas.py`,
`ssqueezepy_tpu/ops/ssq_pallas.py`), whose backward is `jax.vjp` of the
XLA formulation of the same math.

Each kernel wrapper has its own `torch.autograd.Function`, a subclass of
`Adjoint`, beside it (`ops/cwt_cuda.py`, `ops/ssq_cuda.py`,
`ops/stft_cuda.py`). Its forward runs the wrapper's own launch (for a CPU
tensor, the plain version) unchanged, and marks integer outputs (bin
planes) non-differentiable, as JAX's `round` carries no tangent. Its
backward is `torch.autograd.grad` of a plain PyTorch formulation
recomputed on the saved inputs: torch ops on the tensors' device, as
JAX's backward is XLA on the TPU. It is differentiable once. A wrapper
takes its Function only where `needs_grad` holds; otherwise it runs the
launch directly, at the same host cost and bits as without autograd.
"""
import torch
from torch.autograd.function import once_differentiable

__all__ = ['Adjoint', 'needs_grad']


def needs_grad(*tensors):
    """True where autograd records and one of `tensors` (None allowed)
    requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class Adjoint(torch.autograd.Function):
    """`Sub.apply(run, vjp, *inputs)`: the outputs `run(*inputs)` (a
    tuple; None allowed). Backward: the gradient of `vjp(*inputs)` (a tuple
    of run's length: the plain formulation of each floating output, None
    where an output carries no gradient) in the outputs' cotangents, with
    respect to the inputs that require grad."""

    @staticmethod
    def forward(ctx, run, vjp, *inputs):
        ctx.set_materialize_grads(False)
        ctx.vjp = vjp
        ctx.save_for_backward(*inputs)
        outs = run(*inputs)
        for o in outs:
            if o is not None and not (o.is_floating_point() or o.is_complex()):
                ctx.mark_non_differentiable(o)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [None if t is None else
                   t.detach().requires_grad_(n) for t, n in
                   zip(ctx.saved_tensors, need)]
            pairs = [(o, g) for o, g in zip(ctx.vjp(*ins), grads)
                     if o is not None and g is not None and o.requires_grad]
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None) + tuple(next(got) if n else None for n in need)
