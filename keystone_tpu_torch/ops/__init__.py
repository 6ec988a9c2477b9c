"""The port's hand-written kernels. Importing the package registers K1 as
the ``keystone::gaussian_kernel_block`` custom operator, which a saved
``torch.export`` program names."""

from . import gaussian_kernel  # noqa: F401
