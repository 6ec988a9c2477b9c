"""The control for K1, whose configuration states its cross term in 3xTF32:
the plain kernel block put in K1's place with its cross term in one TF32
pass (the norms, clamp and exponential in float32), the step a faster K1
would take first. Every other product stays as the configuration states.
It must come out not correct in every cell that runs K1."""

from __future__ import annotations


def k1_one_pass(X, Xb, gamma: float):
    """exp(−γ·max(‖x‖² − 2x·y + ‖y‖², 0)) with x·y in one TF32 pass."""
    import torch

    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cross = X @ Xb.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    xn = torch.sum(X * X, dim=1, keepdim=True)
    bn = torch.sum(Xb * Xb, dim=1)
    return torch.exp(-gamma * torch.clamp_min(xn - 2.0 * cross + bn, 0.0))


def install():
    """Put the one-pass block in K1's place (the kernel nodes call it by
    ``nodes/learning/kernel.py::_gaussian_block``, eagerly and while a CUDA
    graph captures); returns the call that puts K1 back."""
    from keystone_tpu_torch.nodes.learning import kernel

    k1 = kernel._gaussian_block

    def block(X, Xb, gamma):
        return k1_one_pass(X.float(), Xb.float(), float(gamma))

    kernel._gaussian_block = block

    def undo() -> None:
        kernel._gaussian_block = k1

    return undo
