"""Tokenizers: an HF tokenizer from a local directory (or a name
transformers can resolve), or the byte-level tokenizer, which keeps a
random-weight server hermetic (no downloads). The port of
``llmd_tpu/serve/tokenizer.py``.
"""

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


class HFTokenizerWrapper:
    """The byte tokenizer's surface over a transformers tokenizer."""

    def __init__(self, tok) -> None:
        self._tok = tok
        self.pad_token_id = tok.pad_token_id or 0
        self.bos_token_id = tok.bos_token_id
        self.eos_token_id = tok.eos_token_id

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def apply_chat_template(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tokenize: bool = False,
    ):
        """The tokenizer's chat template. Where it has none (or it fails),
        the byte tokenizer's role-tagged text, encoded by this tokenizer:
        the reference's own fallback, kept so that both servers render the
        same prompt."""
        try:
            return self._tok.apply_chat_template(
                messages,
                add_generation_prompt=add_generation_prompt,
                tokenize=tokenize,
            )
        except Exception:
            text = ByteTokenizer().apply_chat_template(messages, add_generation_prompt, False)
            return self.encode(text) if tokenize else text


def load_tokenizer(path: str | None):
    """``None`` or ``"byte"``: the byte tokenizer. Anything else is an HF
    tokenizer (a local directory, or a name transformers resolves);
    transformers is imported here, only then, and a missing package
    raises."""
    if not path or path == "byte":
        return ByteTokenizer()
    from transformers import AutoTokenizer

    return HFTokenizerWrapper(AutoTokenizer.from_pretrained(path))
