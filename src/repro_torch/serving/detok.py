"""Incremental detokenization for streamed serving output (the port's own
copy of ``repro.serving.detok``; standard library only).

The repo has no real tokenizer, so the serving stack treats
detokenization as an injected ``ids -> text`` function.  The engine wraps
it in :class:`IncrementalDetok`, which re-decodes the full generated
sequence after every token and emits only the *suffix* that appeared --
the standard way to stream text from tokenizers whose piece boundaries
depend on context (a new token may extend the spelling of the previous
one, so decoding tokens one at a time is wrong in general).

Contract: the decode function must be *prefix-monotone* -- decoding a
longer token sequence only appends text, never rewrites what an earlier
prefix produced.  Under that contract the concatenation of all streamed
deltas equals the full detokenization of the final token list.  A decode
function that breaks it raises.
"""

from __future__ import annotations

from typing import Callable, List


def default_decode(ids: List[int]) -> str:
    """Deterministic synthetic detokenizer: ``<id>`` per token."""
    return "".join(f"<{int(i)}>" for i in ids)


class IncrementalDetok:
    """Per-request streaming detokenizer state.

    ``push(token)`` appends the token, re-decodes, and returns the new
    text delta; ``text`` holds everything decoded so far.
    """

    def __init__(self, decode: Callable[[List[int]], str] = default_decode):
        self.decode = decode
        self.tokens: List[int] = []
        self.text: str = ""

    def push(self, token: int) -> str:
        self.tokens.append(int(token))
        full = self.decode(self.tokens)
        if not full.startswith(self.text):
            raise ValueError(
                "detok decode function is not prefix-monotone: decoding "
                f"{len(self.tokens)} tokens rewrote already-emitted text")
        delta = full[len(self.text):]
        self.text = full
        return delta
