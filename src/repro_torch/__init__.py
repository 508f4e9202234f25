"""PyTorch/CUDA port of the RoBatch serving stack (``repro``'s JAX package).

The port stands alone: it imports PyTorch, numpy and the standard library,
never JAX and nothing of the JAX package, and keeps its own copies of the
modules it needs.  The JAX package is the reference the port's tests hold it
against.  Entry points take ``device="cuda"`` by default; on the card the
kernels are the hand-written CUDA kernels under ``csrc/``, and on
the CPU (``device="cpu"``) their plain PyTorch versions run.
"""
