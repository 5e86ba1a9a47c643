"""Byte-level tokenizer: keeps the server hermetic (no downloads)."""

from __future__ import annotations

from collections.abc import Sequence


class ByteTokenizer:
    """Deterministic UTF-8 byte tokenizer: id = byte + 3; 0/1/2 = pad/bos/eos.

    Vocabulary of 259 fits any model config with vocab_size >= 259.
    """

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    _OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self._OFFSET

    def encode(self, text: str) -> list[int]:
        return [self.bos_token_id] + [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        """The text of the byte tokens; special tokens are dropped."""
        data = bytes(
            i - self._OFFSET for i in ids if self._OFFSET <= i < 256 + self._OFFSET
        )
        return data.decode("utf-8", errors="replace")
