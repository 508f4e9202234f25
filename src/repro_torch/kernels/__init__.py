"""Kernels of the port (attention and the RWKV6 and RG-LRU recurrences):
hand-written CUDA for the card, each with a plain PyTorch version beside it
(see ``ops`` for the dispatch)."""
