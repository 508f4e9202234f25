"""Attention kernels of the port: hand-written CUDA for the card, each with a
plain PyTorch version beside it (see ``ops`` for the dispatch)."""
