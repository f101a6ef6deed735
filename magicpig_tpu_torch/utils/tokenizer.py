"""Offline byte-level tokenizer (port of the fallback in
`magicpig_tpu/utils/tokenizer.py`): lets `LLM.generate` take text with no
network and no tokenizer files."""

from __future__ import annotations


class ByteTokenizer:
    """Reversible byte-level tokenizer: token id = byte value + 3.

    Reserves 0=pad, 1=bos, 2=eos. Vocab 259 <= any model vocab.
    """

    bos_token_id = 1
    eos_token_id = 2

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        data = bytes(i - 3 for i in ids if 3 <= i < 259)
        return data.decode("utf-8", errors="replace")
