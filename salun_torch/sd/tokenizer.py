"""Byte-level BPE tokenizer for CLIP (counterpart of
``salun/sd/tokenizer.py``, the port's own copy; pure Python and numpy).

Parity target: the tokenizer used by ``FrozenCLIPEmbedder``
(SD/ldm/modules/encoders/modules.py:230-266) — HF ``CLIPTokenizer`` for
``openai/clip-vit-large-patch14``: lowercased byte-level BPE over a 49,408
vocab (256 byte symbols + 256 end-of-word byte symbols + 48,894 merges +
``<|startoftext|>``/``<|endoftext|>``), context padded to 77 with the
end-of-text token.

Asset-driven; fails loudly when no vocab/merges are available. There is no
approximate fallback: wrong token ids silently poison the text
conditioning of every SD run.

Asset layouts, searched in order by :func:`load_clip_tokenizer`:
  1. the ``path`` argument, then ``$SALUN_CLIP_BPE``: an OpenAI
     ``bpe_simple_vocab_16e6.txt[.gz]`` merges file or a directory holding
     HF ``vocab.json`` + ``merges.txt``;
  2. ``<checkout>/assets/bpe_simple_vocab_16e6.txt[.gz]``.
Unlike the JAX package, the port reads nothing outside its checkout and
the named files (no HF hub cache, no ``~/.cache/clip``).

Differences from the HF original (not load-bearing for SD prompts): no
ftfy mojibake repair, and ``\\p{N}`` is approximated by ``\\d``.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BOS_ID = 49406
EOS_ID = 49407
CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte ↔ printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_WHITESPACE = re.compile(r"\s+")
# CLIP's pattern with \p{L} → [^\W\d_] (unicode letters) and \p{N} → \d.
# CLIP's final class [^\s\p{L}\p{N}]+ includes '_', hence (?:[^\s\w]|_)+.
_TOKEN_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return _WHITESPACE.sub(" ", text).strip()


class CLIPBPETokenizer:
    """Byte-level BPE with CLIP's end-of-word convention."""

    def __init__(self, merges: List[Tuple[str, str]],
                 vocab: Optional[Dict[str, int]] = None):
        self.byte_encoder = bytes_to_unicode()
        if vocab is None:
            # OpenAI construction: derive the vocab from the merge list.
            symbols = list(self.byte_encoder.values())
            tokens = symbols + [s + "</w>" for s in symbols]
            tokens += ["".join(m) for m in merges]
            tokens += ["<|startoftext|>", "<|endoftext|>"]
            vocab = {t: i for i, t in enumerate(tokens)}
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.bos_id = vocab.get("<|startoftext|>", BOS_ID)
        self.eos_id = vocab.get("<|endoftext|>", EOS_ID)
        self._cache = {"<|startoftext|>": "<|startoftext|>",
                       "<|endoftext|>": "<|endoftext|>"}

    # -- core BPE ----------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids for one string, without specials or padding."""
        ids: List[int] = []
        for tok in _TOKEN_PAT.findall(_clean(text).lower()):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(mapped).split(" "))
        return ids

    def __call__(self, texts: Sequence[str],
                 max_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """HF-CLIPTokenizer-equivalent batch encode: BOS + ids (truncated)
        + EOS, padded to ``max_length`` with the EOS/pad token (the SD
        recipe: padding="max_length", modules.py:234-238)."""
        out = np.full((len(texts), max_length), self.eos_id, np.int32)
        out[:, 0] = self.bos_id
        for i, t in enumerate(texts):
            ids = self.encode(t)[: max_length - 2]
            out[i, 1:1 + len(ids)] = ids
            out[i, 1 + len(ids)] = self.eos_id
        return out


# ---------------------------------------------------------------- loading


def _load_openai_merges(path: str) -> List[Tuple[str, str]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    # OpenAI file: line 0 is a header; merges occupy [1, 49152-256-2+1).
    merges = lines[1:49152 - 256 - 2 + 1]
    return [tuple(m.split()) for m in merges if m]


def _load_hf_dir(path: str) -> CLIPBPETokenizer:
    with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(m.split()) for m in lines
              if m and not m.startswith("#version")]
    return CLIPBPETokenizer(merges, vocab)


def load_clip_tokenizer(path: Optional[str] = None) -> CLIPBPETokenizer:
    """Resolve a real CLIP tokenizer from local assets; raise otherwise."""
    candidates = []
    if path:
        candidates.append(path)
    env = os.environ.get("SALUN_CLIP_BPE")
    if env:
        candidates.append(env)
    for c in candidates:
        if os.path.isdir(c):
            return _load_hf_dir(c)
        if os.path.exists(c):
            return CLIPBPETokenizer(_load_openai_merges(c))

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt"):
        c = os.path.join(root, "assets", name)
        if os.path.exists(c):
            return CLIPBPETokenizer(_load_openai_merges(c))

    raise FileNotFoundError(
        "No CLIP tokenizer assets found. Provide $SALUN_CLIP_BPE (an OpenAI "
        "bpe_simple_vocab_16e6.txt[.gz] or an HF dir with vocab.json + "
        "merges.txt) or <checkout>/assets/bpe_simple_vocab_16e6.txt.gz. "
        "Refusing to tokenize approximately: wrong ids would silently "
        "corrupt SD conditioning (reference: "
        "SD/ldm/modules/encoders/modules.py:230-266).")
