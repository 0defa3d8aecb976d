"""Character-level tokenizer, one char = one token (a copy of
``kuzu/data/tokenizer.py``'s ``CharTokenizer``: NFKC normalisation, the five
special tokens, BOS/EOS encoding with fixed-length padding, JSON save/load),
and its bigram variant ``BigramTokenizer``. Numpy only.
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path
from typing import Iterable

import numpy as np

PAD, UNK, BOS, EOS, MASK = "<pad>", "<unk>", "<s>", "</s>", "<mask>"
SPECIALS = [PAD, UNK, BOS, EOS, MASK]


class CharTokenizer:
    def __init__(self, vocab: dict[str, int] | None = None, nfkc: bool = True):
        self.nfkc = nfkc
        if vocab is None:
            vocab = {tok: i for i, tok in enumerate(SPECIALS)}
        self.vocab = dict(vocab)
        self.inv = {i: c for c, i in self.vocab.items()}

    # ----------------------------------------------------------- properties
    pad_id = property(lambda self: self.vocab[PAD])
    unk_id = property(lambda self: self.vocab[UNK])
    bos_id = property(lambda self: self.vocab[BOS])
    eos_id = property(lambda self: self.vocab[EOS])
    mask_id = property(lambda self: self.vocab[MASK])

    def __len__(self) -> int:
        return len(self.vocab)

    # --------------------------------------------------------------- build
    @classmethod
    def train(
        cls,
        texts: Iterable[str],
        min_freq: int = 1,
        max_vocab: int | None = None,
        nfkc: bool = True,
    ) -> "CharTokenizer":
        counts: dict[str, int] = {}
        for t in texts:
            if nfkc:
                t = unicodedata.normalize("NFKC", t)
            for ch in t:
                counts[ch] = counts.get(ch, 0) + 1
        chars = sorted(
            (c for c, n in counts.items() if n >= min_freq),
            key=lambda c: (-counts[c], c),
        )
        if max_vocab is not None:
            chars = chars[: max_vocab - len(SPECIALS)]
        vocab = {tok: i for i, tok in enumerate(SPECIALS)}
        for c in chars:
            vocab[c] = len(vocab)
        return cls(vocab, nfkc=nfkc)

    @classmethod
    def from_unicode_ids(cls, ids: Iterable[str], nfkc: bool = True) -> "CharTokenizer":
        """Build from 'U+XXXX' code strings (column_info.csv vocabulary)."""
        return cls.train([decode_unicode_ids(" ".join(ids))], nfkc=nfkc)

    # -------------------------------------------------------------- encode
    def normalize(self, text: str) -> str:
        return unicodedata.normalize("NFKC", text) if self.nfkc else text

    def encode(
        self,
        text: str,
        max_length: int | None = None,
        add_special: bool = True,
    ) -> np.ndarray:
        ids = [self.vocab.get(c, self.unk_id) for c in self.normalize(text)]
        return self._finish(ids, max_length, add_special)

    def _finish(self, ids: list[int], max_length: int | None, add_special: bool) -> np.ndarray:
        """BOS / EOS around ``ids``, cut to ``max_length`` (EOS kept last)
        and padded."""
        if add_special:
            ids = [self.bos_id] + ids + [self.eos_id]
        if max_length is not None:
            ids = ids[:max_length]
            if add_special and len(ids) == max_length and ids[-1] != self.eos_id:
                ids[-1] = self.eos_id
            ids = ids + [self.pad_id] * (max_length - len(ids))
        return np.asarray(ids, np.int32)

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        out = []
        for i in ids:
            c = self.inv.get(int(i), UNK)
            if skip_special and c in SPECIALS:
                if c == EOS:
                    break
                continue
            out.append(c)
        return "".join(out)

    def batch_decode(self, batch: np.ndarray) -> list[str]:
        return [self.decode(row) for row in np.asarray(batch)]

    # ----------------------------------------------------------------- i/o
    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(
            json.dumps({"vocab": self.vocab, "nfkc": self.nfkc}, ensure_ascii=False)
        )

    @classmethod
    def load(cls, path: str | Path) -> "CharTokenizer":
        data = json.loads(Path(path).read_text())
        return cls(data["vocab"], nfkc=data.get("nfkc", True))


class BigramTokenizer(CharTokenizer):
    """Bigram variant (reference ``train_tokenizer_bigram.py``): the vocab
    holds every character, then the character bigrams seen ``min_freq``
    times or more (most frequent first, up to ``max_vocab``); encoding is
    greedy longest-match (the bigram at the position if it is in the vocab,
    else the character, else ``<unk>``). ``save`` / ``load`` as
    ``CharTokenizer``'s."""

    @classmethod
    def train(
        cls,
        texts: Iterable[str],
        min_freq: int = 2,
        max_vocab: int | None = None,
        nfkc: bool = True,
    ) -> "BigramTokenizer":
        chars: dict[str, int] = {}
        bigrams: dict[str, int] = {}
        for t in texts:
            if nfkc:
                t = unicodedata.normalize("NFKC", t)
            for ch in t:
                chars[ch] = chars.get(ch, 0) + 1
            for i in range(len(t) - 1):
                bg = t[i: i + 2]
                bigrams[bg] = bigrams.get(bg, 0) + 1
        vocab = {tok: i for i, tok in enumerate(SPECIALS)}
        for c in sorted(chars, key=lambda c: (-chars[c], c)):
            vocab[c] = len(vocab)
        for bg in sorted(bigrams, key=lambda b: (-bigrams[b], b)):
            if bigrams[bg] >= min_freq and (max_vocab is None or len(vocab) < max_vocab):
                vocab[bg] = len(vocab)
        return cls(vocab, nfkc=nfkc)

    def encode(self, text: str, max_length: int | None = None,
               add_special: bool = True) -> np.ndarray:
        t = self.normalize(text)
        ids: list[int] = []
        i = 0
        while i < len(t):
            bg = t[i: i + 2]
            if len(bg) == 2 and bg in self.vocab:
                ids.append(self.vocab[bg])
                i += 2
            else:
                ids.append(self.vocab.get(t[i], self.unk_id))
                i += 1
        return self._finish(ids, max_length, add_special)


def decode_unicode_ids(s: str) -> str:
    """'U+4E00 U+3042' -> characters (reference trocr_dataset.py:139)."""
    out = []
    for tok in str(s).split():
        if tok.upper().startswith("U+"):
            try:
                out.append(chr(int(tok[2:], 16)))
            except ValueError:
                out.append("�")
        else:
            out.append(tok)
    return "".join(out)
