"""Self-contained CLIP byte-level BPE tokenizer (host-side).

The reference tokenizes it_sim category prompts through ImageBind's bundled
SimpleTokenizer (avgen/evaluations/models/clip.py:59-74 ->
imagebind.data.load_and_transform_text), which is OpenAI CLIP's BPE.  This
module re-implements that algorithm with no transformers dependency so eval
works offline; it loads the merge table from either

  * the SD1.5 tokenizer export: vocab.json + merges.txt
    (pretrained/stable-diffusion-v1-5/tokenizer/), or
  * ImageBind's bpe_simple_vocab_16e6.txt.gz (the vocabulary is
    reconstructed from the merges exactly as OpenAI CLIP does).

Both produce the same 49408-entry vocabulary and identical token ids.
Sequences are wrapped in <|startoftext|> ... <|endoftext|>, truncated to
the context length and zero-padded (ImageBind convention; the trailing pad
is invisible to the causally-masked, EOS-pooled text tower).
"""
from __future__ import annotations

import gzip
import html
import json
import os
from functools import lru_cache
from typing import List, Sequence

import numpy as np


@lru_cache()
def _bytes_to_unicode():
    """OpenAI CLIP/GPT-2 byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _whitespace_clean(text: str) -> str:
    import regex as re
    return re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    # ftfy.fix_text is a no-op on clean ASCII category prompts; html
    # unescape twice mirrors CLIP's basic_clean
    return html.unescape(html.unescape(text)).strip()


class ClipBPETokenizer:
    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, merges: Sequence[tuple], encoder: dict):
        import regex as re
        self.byte_encoder = _bytes_to_unicode()
        self.encoder = dict(encoder)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.cache = {self.SOT: self.SOT, self.EOT: self.EOT}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", re.IGNORECASE)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str) -> "ClipBPETokenizer":
        """`path`: a directory holding vocab.json+merges.txt, or an
        ImageBind bpe .txt.gz file (or a directory holding one)."""
        if os.path.isdir(path):
            vj = os.path.join(path, "vocab.json")
            mt = os.path.join(path, "merges.txt")
            if os.path.isfile(vj) and os.path.isfile(mt):
                return cls.from_vocab_merges(vj, mt)
            gz = os.path.join(path, "bpe_simple_vocab_16e6.txt.gz")
            if os.path.isfile(gz):
                return cls.from_clip_bpe_gz(gz)
            raise FileNotFoundError(
                f"no vocab.json+merges.txt or bpe_simple_vocab_16e6.txt.gz "
                f"under {path}")
        if path.endswith(".gz"):
            return cls.from_clip_bpe_gz(path)
        raise FileNotFoundError(path)

    @classmethod
    def from_vocab_merges(cls, vocab_json: str,
                          merges_txt: str) -> "ClipBPETokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        return cls(merges, encoder)

    @classmethod
    def from_clip_bpe_gz(cls, path: str) -> "ClipBPETokenizer":
        """Reconstruct the vocabulary from the raw merge list exactly as
        OpenAI CLIP's SimpleTokenizer does (48894 merges + 512 byte tokens
        + 2 specials = 49408 entries)."""
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1:48894 + 1]]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([cls.SOT, cls.EOT])
        encoder = {tok: i for i, tok in enumerate(vocab)}
        return cls(merges, encoder)

    # -- BPE ---------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
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
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return tokens

    def __call__(self, texts, context_length: int = 77,
                 pad: str = "zero") -> np.ndarray:
        """(n, context_length) int32 ids: SOT + bpe + EOT, padded.

        pad="zero": ImageBind SimpleTokenizer convention (it_sim tower,
        EOS-pooled + causal, so the pad value is invisible).
        pad="eot": transformers CLIPTokenizer(padding="max_length")
        convention — REQUIRED for the SD1.5 text encoder, whose full
        77-token output conditions the UNet, so pad ids change encodings.
        """
        if isinstance(texts, str):
            texts = [texts]
        sot, eot = self.encoder[self.SOT], self.encoder[self.EOT]
        fill = 0 if pad == "zero" else eot
        out = np.full((len(texts), context_length), fill, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [sot] + self.encode(text) + [eot]
            if len(ids) > context_length:   # truncate, keep EOT last
                ids = ids[:context_length - 1] + [eot]
            out[i, :len(ids)] = ids
        return out
