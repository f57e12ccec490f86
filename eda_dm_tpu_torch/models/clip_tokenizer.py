"""CLIP's byte-level BPE tokenizer (the port of ``transformers``'
``CLIPTokenizer``, which the JAX package's CLIP classes load).

It follows the path ``transformers`` takes where ``ftfy`` is absent, the
one the JAX package takes:

1. special tokens (``<|startoftext|>``, ``<|endoftext|>`` and the unknown
   and pad tokens) are split out of the text as they are;
2. each other piece is cleaned as ``BasicTokenizer(strip_accents=False,
   do_split_on_punc=False)`` cleans it: NUL, U+FFFD and control
   characters dropped, whitespace made a space, CJK ideographs spaced,
   NFC, split on whitespace, lower-cased;
3. the words of CLIP's pattern ``<|startoftext|>|<|endoftext|>|'s|'t|'re|
   've|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` are mapped byte by
   byte through ``bytes_to_unicode`` and merged by the ranks of
   ``merges.txt`` (its first 49152 − 256 − 2 lines after the header), the
   last symbol of a word carrying ``</w>``;
4. ids from ``vocab.json`` (the unknown token's for a symbol it lacks),
   cut to ``max_length − 2``, framed by the bos and eos ids and padded
   with the pad token's id; ``attention_mask`` marks the tokens.

The pattern runs on ``re``, with the letter and number classes spelled
out from ``unicodedata`` (Unicode categories L* and N*), so the
tokenizer needs no ``regex`` package.

``write_synthetic_vocab`` writes a vocabulary of a given size (the 512
byte symbols, merges learned from some texts, filler merges, the two
specials last) for runs on random weights.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
MERGES_KEPT = 49152 - 256 - 2
_CONTRACTIONS = r"'s|'t|'re|'ve|'m|'ll|'d"


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """Each byte → a printable character: the printable Latin-1 bytes map
    to themselves, the others to U+0100 onwards in byte order."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# --------------------------------------------------------------------------
# the text before BPE
# --------------------------------------------------------------------------

def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``:
    the cleaned, lower-cased words joined by single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.extend((" ", ch, " "))
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(w.lower() for w in words)


@functools.lru_cache(maxsize=None)
def _unicode_classes() -> Tuple[str, str]:
    """The letter (L*) and number (N*) categories as ``re`` class bodies."""
    spans = {"L": [], "N": []}
    for cp in range(0x110000):
        cat = unicodedata.category(chr(cp))[0]
        if cat in spans:
            s = spans[cat]
            if s and s[-1][1] == cp - 1:
                s[-1][1] = cp
            else:
                s.append([cp, cp])
    body = lambda s: "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                             for a, b in s)
    return body(spans["L"]), body(spans["N"])


@functools.lru_cache(maxsize=None)
def word_pattern():
    """CLIP's word pattern, compiled by ``re`` with the letter and number
    classes spelled out."""
    import re
    letters, numbers = _unicode_classes()
    return re.compile(
        rf"<\|startoftext\|>|<\|endoftext\|>|{_CONTRACTIONS}|[{letters}]+|[{numbers}]"
        rf"|[^\s{letters}{numbers}]+",
        re.IGNORECASE)


def split_words(text: str) -> List[str]:
    """A piece of text without special tokens → its byte-encoded words."""
    enc = bytes_to_unicode()
    return ["".join(enc[b] for b in w.encode("utf-8"))
            for w in word_pattern().findall(basic_clean(text))]


def merge_pair(word: Tuple[str, ...], first: str, second: str) -> Tuple[str, ...]:
    """Every occurrence of (first, second) in ``word`` merged, left to right."""
    out, i = [], 0
    while i < len(word):
        if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
            out.append(first + second)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return tuple(out)


def _as_word(token: str) -> Tuple[str, ...]:
    return tuple(token[:-1]) + (token[-1] + "</w>",)


# --------------------------------------------------------------------------
# the tokenizer
# --------------------------------------------------------------------------

def _token_name(v) -> Optional[str]:
    """A special token in ``tokenizer_config.json``: a string or a
    serialised ``AddedToken`` (its ``content``)."""
    return v.get("content") if isinstance(v, dict) else v


class CLIPTokenizer:
    """``vocab.json`` and ``merges.txt`` (and, where present,
    ``tokenizer_config.json``'s special tokens) → ids and masks as
    ``transformers``' ``CLIPTokenizer`` gives them on its path without
    ``ftfy``."""

    def __init__(self, vocab_file: str, merges_file: str, bos_token: str = BOS,
                 eos_token: str = EOS, unk_token: str = EOS, pad_token: str = EOS):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MERGES_KEPT + 1]
        self.bpe_ranks = {tuple(m.split()): r for r, m in enumerate(lines)}
        self.specials = {}
        for name, tok in (("bos", bos_token), ("eos", eos_token), ("unk", unk_token),
                          ("pad", pad_token)):
            if tok not in self.encoder:
                raise ValueError(f"the {name} token {tok!r} is not in {vocab_file}")
            self.specials[tok] = self.encoder[tok]
        self.bos_token_id, self.eos_token_id = self.encoder[bos_token], self.encoder[eos_token]
        self.unk_token_id, self.pad_token_id = self.encoder[unk_token], self.encoder[pad_token]
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "CLIPTokenizer":
        """The tokenizer of a local checkout: ``vocab.json``, ``merges.txt``
        and the special tokens that ``tokenizer_config.json`` names."""
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                if cfg.get(key) is not None:
                    kw.setdefault(key, _token_name(cfg[key]))
        return cls(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), **kw)

    def bpe(self, word: str) -> List[str]:
        """One byte-encoded word → its BPE symbols (lowest rank first)."""
        if word in self._cache:
            return self._cache[word]
        sym = _as_word(word)
        while len(sym) > 1:
            pairs = set(zip(sym, sym[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            sym = merge_pair(sym, *best)
        self._cache[word] = list(sym)
        return self._cache[word]

    def tokenize(self, text: str) -> List[str]:
        out = []
        for piece in self._split_specials(text):
            if piece in self.specials:
                out.append(piece)
            else:
                for w in split_words(piece):
                    out.extend(self.bpe(w))
        return out

    def _split_specials(self, text: str) -> List[str]:
        pieces, i = [], 0
        names = sorted(self.specials, key=len, reverse=True)
        start = 0
        while i < len(text):
            hit = next((s for s in names if text.startswith(s, i)), None)
            if hit is None:
                i += 1
                continue
            pieces += [text[start:i], hit]
            i = start = i + len(hit)
        pieces.append(text[start:])
        return [p for p in pieces if p]

    def encode(self, text: str, max_length: int) -> List[int]:
        """[bos] + ids + [eos], the ids cut so that the whole fits
        ``max_length``."""
        ids = [self.encoder.get(t, self.unk_token_id) for t in self.tokenize(text)]
        ids = ids[:max(max_length - 2, 0)]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def __call__(self, texts, max_length: int = 77, truncation: bool = True,
                 padding="max_length", return_tensors: str = "np") -> Dict[str, np.ndarray]:
        """Texts → ``{"input_ids", "attention_mask"}`` as int64 numpy arrays
        (B, ``max_length``), the call ``transformers``' tokenizer takes (only
        with truncation, ``padding="max_length"`` and ``return_tensors="np"``)."""
        if not truncation or padding != "max_length" or return_tensors != "np":
            raise ValueError(f"truncation={truncation!r}, padding={padding!r}, return_tensors="
                             f"{return_tensors!r}: only True, 'max_length' and 'np' are supported")
        rows = [self.encode(t, max_length) for t in texts]
        ids = np.full((len(rows), max_length), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), max_length), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)], mask[i, :len(r)] = r, 1
        return {"input_ids": ids, "attention_mask": mask}


# --------------------------------------------------------------------------
# a synthetic vocabulary for random-weight runs
# --------------------------------------------------------------------------

def write_synthetic_vocab(directory: str, texts: Sequence[str],
                          vocab_size: int = 49408) -> Dict[str, int]:
    """Write ``vocab.json`` and ``merges.txt`` of ``vocab_size`` entries in
    CLIP's layout into ``directory``: the 256 byte symbols and the same
    with ``</w>``, then one token a merge (the merges BPE learns from
    ``texts``, most frequent pair first, so each word of the texts becomes
    one token; then filler merges of two byte symbols), and the specials
    ``<|startoftext|>`` and ``<|endoftext|>`` last.  Returns the vocab."""
    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars]
    known = set(vocab)
    words = collections.Counter(_as_word(w) for t in texts for w in split_words(t))
    merges: List[Tuple[str, str]] = []

    def add(pair):
        merges.append(pair)
        if pair[0] + pair[1] not in known:
            vocab.append(pair[0] + pair[1])
            known.add(pair[0] + pair[1])

    budget = vocab_size - 2
    while len(vocab) < budget:
        counts = collections.Counter()
        for w, n in words.items():
            for p in zip(w, w[1:]):
                counts[p] += n
        if not counts:
            break
        best = min(counts, key=lambda p: (-counts[p], p))
        add(best)
        words = collections.Counter({merge_pair(w, *best): n for w, n in words.items()})
    taken = set(merges)
    for a in chars:
        for b in chars:
            if len(vocab) >= budget:
                break
            if (a, b) not in taken and a + b not in known:
                add((a, b))
    if len(vocab) != budget:
        raise ValueError(f"cannot fill a vocabulary of {vocab_size}")
    vocab += [BOS, EOS]
    encoder = {t: i for i, t in enumerate(vocab)}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(encoder, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return encoder
