"""Tokenizers of the three text front-ends (``vdtpu/data/tokenizers.py``),
the port's own copy: BERT WordPiece (the Optimus encoder's input), GPT-2
byte-level BPE (the Optimus decoder's output) and CLIP's lowercased BPE
with </w> markers (the text context encoder's input).

Vocabulary and merges files are paths the user supplies; none ships with
the repository. The BPE patterns use Unicode classes (\\p{L}, \\p{N}) from
the ``regex`` package, imported when a BPE tokenizer is built, so importing
this module needs nothing beyond the standard library and numpy.
"""
from __future__ import annotations

import functools
import json
import re
import unicodedata
from typing import Sequence

import numpy as np


class BertWordPieceTokenizer:
    """Cased WordPiece (the bert-base-cased vocabulary, 28996 entries):
    invalid and control characters dropped, CJK ideographs spaced, the
    never-split specials kept, punctuation split by Unicode category, NFD
    accents stripped under lowercasing, greedy longest-match wordpieces,
    [CLS] ... [SEP] wrapping and padding with id 0."""

    SPECIALS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")

    def __init__(self, vocab_file: str, do_lower_case: bool = False,
                 tokenize_chinese_chars: bool = True,
                 never_split: Sequence[str] | None = None):
        self.vocab: dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.do_lower_case = do_lower_case
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.never_split = set(never_split or self.SPECIALS)
        self.unk = "[UNK]"
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab.get("[PAD]", 0)

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or
                (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or
                (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF) or
                (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))

    def _space_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if self._is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text: str) -> list[str]:
        out: list[list[str]] = []
        start_new = True
        for ch in text:
            if _is_punct(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    def _basic_split(self, text: str) -> list[str]:
        text = self._clean_text(text)
        if self.tokenize_chinese_chars:
            text = self._space_cjk(text)
        split_tokens: list[str] = []
        for token in text.strip().split():
            if token in self.never_split:
                split_tokens.append(token)
                continue
            if self.do_lower_case:
                token = self._strip_accents(token.lower())
            split_tokens.extend(self._split_on_punc(token))
        return " ".join(split_tokens).strip().split()

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > 100:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in self._basic_split(text):
            if word in self.never_split:
                out.append(word)
            else:
                out.extend(self._wordpiece(word))
        return out

    def __call__(self, texts: Sequence[str], max_length: int = 77) -> np.ndarray:
        """Ids [len(texts), n]: at most max_length wordpieces each, wrapped in
        [CLS]/[SEP], padded with the pad id to the longest row."""
        rows = []
        for t in texts:
            ids = [self.vocab.get(p, self.vocab[self.unk])
                   for p in self.tokenize(t)[:max_length]]
            rows.append([self.cls_id] + ids + [self.sep_id])
        n = max(len(r) for r in rows)
        return np.array([r + [self.pad_id] * (n - len(r)) for r in rows], np.int32)


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 reversible byte <-> unicode table."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _merge(word: tuple[str, ...], ranks: dict[tuple[str, str], int]) -> tuple[str, ...]:
    """Apply the lowest-ranked merge until none applies."""
    while len(word) > 1:
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        best = min(pairs, key=lambda p: ranks.get(p, 1 << 60))
        if best not in ranks:
            break
        first, second = best
        out, i = [], 0
        while i < len(word):
            if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                out.append(first + second)
                i += 2
            else:
                out.append(word[i])
                i += 1
        word = tuple(out)
    return word


class _BPE:
    def __init__(self, merges: list[tuple[str, str]]):
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict[str, tuple[str, ...]] = {}

    def __call__(self, token: str) -> tuple[str, ...]:
        if token not in self.cache:
            self.cache[token] = _merge(tuple(token), self.ranks)
        return self.cache[token]


class GPT2BPETokenizer:
    """Byte-level BPE with Optimus' added specials <PAD>/<BOS>/<EOS> (ids
    50257/50258/50259 unless the vocabulary names them)."""

    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                if b:
                    merges.append((a, b))
        self.bpe = _BPE(merges)
        for i, sp in enumerate(("<PAD>", "<BOS>", "<EOS>")):
            self.encoder.setdefault(sp, 50257 + i)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.pad_id, self.bos_id, self.eos_id = (
            self.encoder["<PAD>"], self.encoder["<BOS>"], self.encoder["<EOS>"])
        import regex
        self.pat = regex.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

    def encode(self, text: str) -> list[int]:
        # one leading space, as the Optimus GPT-2 tokenizer adds
        text = " " + text
        unk = self.encoder.get("<|endoftext|>")
        ids = []
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder.get(p, unk) for p in self.bpe(tok))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_dec[c] for c in text if c in self.byte_dec)
        return data.decode("utf-8", errors="replace")


class CLIPTokenizer:
    """CLIP's lowercased BPE with </w> end-of-word markers (vocabulary 49408):
    <|startoftext|> tokens... <|endoftext|>, padded with <|endoftext|> to
    max_length (77), as the HF tokenizer with ftfy's whitespace clean."""

    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        for line in lines[1:]:  # the first line is a version header
            a, _, b = line.partition(" ")
            if b:
                merges.append((a, b))
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_enc = bytes_to_unicode()
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self.cache: dict[str, list[str]] = {}
        import regex
        self.pat = regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"\p{L}+|\p{N}|[^\s\p{L}\p{N}]+", regex.IGNORECASE)

    def _bpe(self, token: str) -> list[str]:
        if token not in self.cache:
            self.cache[token] = list(_merge(tuple(token[:-1]) + (token[-1] + "</w>",),
                                            self.ranks))
        return self.cache[token]

    def encode(self, text: str) -> list[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        unk = self.eos  # HF CLIP's unk token is <|endoftext|>
        ids = []
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder.get(p, unk) for p in self._bpe(tok))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = 77) -> np.ndarray:
        rows = []
        for t in texts:
            ids = [self.bos] + self.encode(t)[:max_length - 2] + [self.eos]
            rows.append(ids + [self.eos] * (max_length - len(ids)))
        return np.array(rows, np.int32)
