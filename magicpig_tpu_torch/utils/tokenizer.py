"""Tokenizer loading with an offline byte-level fallback (port of
`magicpig_tpu/utils/tokenizer.py`): a local HF tokenizer directory when
`transformers` can load it, else `ByteTokenizer`, which lets
`LLM.generate` take text with no network and no tokenizer files."""

from __future__ import annotations

import os


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


def get_tokenizer(name_or_path: str | None):
    """The HF tokenizer saved at the local path `name_or_path` when
    `transformers` is installed and loads it (imported only then),
    `ByteTokenizer` otherwise. Only local files are read: a name that is no
    path on this machine gives the byte tokenizer, where the JAX package
    would ask the HF hub."""
    if name_or_path and os.path.exists(name_or_path):
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(name_or_path,
                                                 local_files_only=True)
        except Exception:
            # No transformers, or a directory without a tokenizer it can
            # load: it raises ImportError, OSError, ValueError, and for a
            # checkpoint directory without tokenizer files AttributeError.
            pass
    return ByteTokenizer()
