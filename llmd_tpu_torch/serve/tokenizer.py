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

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        """The text of the byte tokens; special tokens have no text, so
        they are dropped either way."""
        data = bytes(
            i - self._OFFSET for i in ids if self._OFFSET <= i < 256 + self._OFFSET
        )
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tokenize: bool = False,
    ):
        """The JAX package's role-tagged template, byte for byte: a prompt's
        page hashes, and so prefix hits and ``/v1/cache/probe``, must agree
        with a JAX pod's behind the same router."""
        parts = []
        for m in messages:
            content = m.get("content") or ""
            if isinstance(content, list):  # OpenAI content-part arrays
                content = "".join(
                    p.get("text", "") for p in content if isinstance(p, dict)
                )
            parts.append(f"<|{m.get('role', 'user')}|>{content}</s>")
        if add_generation_prompt:
            parts.append("<|assistant|>")
        text = "".join(parts)
        if tokenize:
            return self.encode(text)
        return text
