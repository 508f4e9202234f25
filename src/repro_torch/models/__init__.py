"""Models of the port: layers, gated MLPs, attention, the RWKV6 and RG-LRU
blocks, the decoder and the weight bridge."""
