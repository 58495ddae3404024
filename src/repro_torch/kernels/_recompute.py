"""The backward shared by the recurrences' kernels (K3, K4): recompute the
plain version from the inputs the forward saved and take its gradients
with autograd.  The JAX package has no backward kernel for either, so the
port's is the plain version's, on purpose."""
from __future__ import annotations

import torch


def ref_backward(ctx, ref, *grads):
    """Gradients, for ``ctx.save_for_backward``'s tensors, of the outputs
    of ``ref(*saved)`` against ``grads`` (None for an output not used).
    Returns one entry an input: a gradient or None."""
    needs = ctx.needs_input_grad
    ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
    want = [t for t in ins if t.requires_grad]
    if not want:
        return (None,) * len(ins)
    with torch.enable_grad():
        outs = ref(*ins)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if n else None for n in needs)
