"""PyTorch/CUDA port of the `repro` JAX package.

The layout mirrors `src/repro/`: ``repro_torch/<pkg>/<mod>.py`` is the
counterpart of ``repro/<pkg>/<mod>.py``. The port imports ``torch`` and
never ``jax``, and nothing from ``repro``: the JAX package is the frozen
reference the port's tests hold it against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
With no GPU and no ``device="cpu"`` they raise; nothing falls back to the
CPU quietly. Kernels dispatch by the tensor's device alone: a CPU tensor
takes the kernel's plain PyTorch version, a CUDA tensor launches the
hand-written kernel (built from ``kernels/csrc`` on first use) or raises.
"""
