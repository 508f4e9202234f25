"""Data utilities of the port: the byte tokenizer."""
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: F401
