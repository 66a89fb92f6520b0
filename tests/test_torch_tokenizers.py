"""The port's tokenizers against the JAX package's, on synthetic
mini-vocabularies written under tmp_path (no vocabulary ships with the
repository): BERT WordPiece, GPT-2 byte-level BPE and CLIP BPE, ids equal
on text with accents, CJK, punctuation, control characters, mixed case and
over-long words; GPT-2 decoding round-trips."""
import json

import numpy as np
import pytest
import regex
import torch

from vdtpu.data import tokenizers as jtok
from vdtpu_torch.data import tokenizers as ptok

torch.set_num_threads(2)

CORPUS = [
    "a photo of a cat sitting on the mat",
    "unbelievable, transformers tokenize sub-words!",
    "the quick brown fox 123 jumped.",
    "Déjà vu — naïve café PROBLÈME!",
    "日本語のテキストと中文字符 mixed with English",
    "control\x00chars\x01and\ttabs\nnewlines\r",
    "emoji 🦊 and math ∑∞ ≠ ±2",
    "hyphen-ated e.g. Dr. Smith's 1,234.56 [bracket] (paren)",
    "ALLCAPS MiXeD case Ünïcödé",
    "   leading/trailing whitespace   ",
    "ﬁligature ﬂow ǅ unusual_underscore x² Ⅻ roman",
    "한국어 텍스트 and हिन्दी numerals ٣٤٥",
    "supercalifragilistic" * 6 + " short",   # a 120-letter word: [UNK] in WordPiece
]


def _bert_vocab(tmp_path, lower: bool):
    """Specials, whole words and ##-pieces of the corpus words (some left
    out, so greedy matching splits and falls back to [UNK])."""
    b = jtok.BertWordPieceTokenizer.__new__(jtok.BertWordPieceTokenizer)
    b.do_lower_case, b.tokenize_chinese_chars = lower, True
    b.never_split = set(jtok.BertWordPieceTokenizer.SPECIALS)
    words = sorted({w for t in CORPUS for w in b._basic_split(t)})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    for i, w in enumerate(words):
        if i % 5 == 3:                 # no entry: pieces or [UNK]
            continue
        if i % 3 == 0 and len(w) > 3:  # a prefix and its ## continuation
            vocab += [w[:3], "##" + w[3:]]
        else:
            vocab.append(w)
    vocab += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"] + list("abcdefghij")
    path = tmp_path / "bert-vocab.txt"
    path.write_text("\n".join(dict.fromkeys(vocab)) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("lower", [False, True])
def test_bert_wordpiece_matches_jax(tmp_path, lower):
    vocab = _bert_vocab(tmp_path, lower)
    ref = jtok.BertWordPieceTokenizer(vocab, do_lower_case=lower)
    ours = ptok.BertWordPieceTokenizer(vocab, do_lower_case=lower)
    texts = CORPUS + [t.lower() for t in CORPUS] + ["[CLS] kept [MASK] specials"]
    unk = 0
    for text in texts:
        assert ours.tokenize(text) == ref.tokenize(text), text
        unk += ours.tokenize(text).count("[UNK]")
    assert unk > 0   # the vocabulary leaves words out on purpose
    for max_length in (77, 5):
        np.testing.assert_array_equal(ours(texts, max_length=max_length),
                                      ref(texts, max_length=max_length))


def _train_bpe(words, end_marker: str = "", n_merges: int = 120):
    """A byte-level BPE trainer: (vocab, merges) over the given words, every
    byte symbol in the vocabulary (so nothing maps to an unknown id)."""
    b2u = ptok.bytes_to_unicode()
    counts = {}
    for w in words:
        sym = ["".join(b2u[b] for b in ch.encode("utf-8")) for ch in w]
        sym[-1] += end_marker
        counts[tuple(sym)] = counts.get(tuple(sym), 0) + 1
    vocab = {}
    for c in b2u.values():
        vocab[c] = len(vocab)
        if end_marker:
            vocab[c + end_marker] = len(vocab)
    merges = []
    for _ in range(n_merges):
        pairs = {}
        for w, cnt in counts.items():
            for i in range(len(w) - 1):
                pairs[(w[i], w[i + 1])] = pairs.get((w[i], w[i + 1]), 0) + cnt
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        vocab.setdefault(best[0] + best[1], len(vocab))
        out = {}
        for w, cnt in counts.items():
            lst, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    lst.append(best[0] + best[1])
                    i += 2
                else:
                    lst.append(w[i])
                    i += 1
            out[tuple(lst)] = out.get(tuple(lst), 0) + cnt
        counts = out
    return vocab, merges


def _write_bpe(tmp_path, vocab, merges):
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n", encoding="utf-8")
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def test_gpt2_bpe_matches_jax_and_round_trips(tmp_path):
    pat = regex.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
    words = [w for t in CORPUS for w in pat.findall(" " + t)]
    vocab, merges = _train_bpe(words)
    vocab["<|endoftext|>"] = len(vocab)
    files = _write_bpe(tmp_path, vocab, merges)
    ref, ours = jtok.GPT2BPETokenizer(*files), ptok.GPT2BPETokenizer(*files)
    assert (ours.pad_id, ours.bos_id, ours.eos_id) == (ref.pad_id, ref.bos_id, ref.eos_id)
    merged = 0
    for text in CORPUS + ["Ünïcödé café's 123 words"]:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.decode(ids) == ref.decode(ids) == " " + text
        merged += len(ids) < len((" " + text).encode("utf-8"))
    assert merged == len(CORPUS) + 1   # the merges shortened every text
    assert ours.decode([ours.bos_id, ours.eos_id]) == ref.decode([ref.bos_id, ref.eos_id])


def test_clip_bpe_matches_jax(tmp_path):
    words = [w for t in CORPUS for w in t.lower().split()]
    vocab, merges = _train_bpe(words, end_marker="</w>", n_merges=80)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    files = _write_bpe(tmp_path, vocab, merges)
    ref, ours = jtok.CLIPTokenizer(*files), ptok.CLIPTokenizer(*files)
    for text in CORPUS:
        assert ours.encode(text) == ref.encode(text), text
    for max_length in (77, 8):
        np.testing.assert_array_equal(ours(CORPUS, max_length=max_length),
                                      ref(CORPUS, max_length=max_length))
