"""Batch prompting at the token level: pack b queries behind one shared
system prompt, parse b answers back out (§2.2 made real).

Wire format (byte tokenizer; full spec + billing semantics in
docs/batch_format.md)::

    <bos>SYSTEM_PROMPT\\nQ1:<q1>\\nQ2:<q2>...\\nQb:<qb>\\nA:

The model is trained (examples/train_lm.py / serve_pool.py) to emit
``<a1>;<a2>;...;<ab><eos>`` — a single shared answer cue (``\\nA:``), with the
separator splitting the answers back out positionally.  The formatter also
*bills* the token counts so the cost model's C_sys / C_q split matches exactly
what was served.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.data.tokenizer import ByteTokenizer


@dataclass
class BatchPromptFormatter:
    system_prompt: str
    sep: str = ";"
    tokenizer: ByteTokenizer = None

    def __post_init__(self):
        if self.tokenizer is None:
            self.tokenizer = ByteTokenizer()

    @property
    def sys_tokens(self) -> int:
        return len(self.tokenizer.encode(self.system_prompt, add_bos=True))

    def format(self, queries: list[str]) -> list[int]:
        parts = [self.system_prompt]
        for i, q in enumerate(queries):
            parts.append(f"\nQ{i + 1}:{q}")
        parts.append("\nA:")
        return self.tokenizer.encode("".join(parts), add_bos=True)

    def query_tokens(self, query: str, idx: int = 0) -> int:
        return len(self.tokenizer.encode(f"\nQ{idx + 1}:{query}", add_bos=False))

    def parse(self, output: str, b: int) -> list[str]:
        """Split the generated text into b answers; missing answers -> ''."""
        parts = [p.strip() for p in output.split(self.sep)]
        parts = parts[:b]
        return parts + [""] * (b - len(parts))
