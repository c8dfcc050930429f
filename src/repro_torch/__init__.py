"""PyTorch / CUDA port of the Winograd / Cook-Toom convolution system.

Mirrors the module layout of the JAX package `repro` so each module has an
obvious counterpart: `core` (transforms, geometry, registry, plans, the
graph compiler), `kernels` (the hand-written Hopper kernels, each beside its
plain PyTorch version), `models` (the CNN zoo) and `optim` (the weight
quantizer). The package imports torch only. Entry points run on the CUDA
device unless the caller passes `device="cpu"`; the per-call ones
(core.dispatch, the unplanned wrappers of kernels.ops) run on the device of
the tensor they are given.
"""
