"""CLIP BPE tokenizer (port of ``hoigen_tpu/models/clip/tokenizer.py``).

The same byte-level BPE over the same merges file
(``bpe_simple_vocab_16e6.txt.gz``, OpenAI CLIP's release file, a copy of
which sits beside this module; ``HOIGEN_BPE_VOCAB`` or a constructor path
overrides it).

The JAX tokenizer splits text with the third-party ``regex`` module
(``\\p{L}``, ``\\p{N}``, ``\\s``). This one uses the standard library's
``re`` with those classes spelled out: letters and numbers are the code
points whose ``unicodedata`` category starts with L or N, whitespace is
Unicode's White_Space set. The two agree on every code point that both
Unicode tables assign the same category (``ROADMAP.md`` C lists the
difference: ``regex`` may carry a newer Unicode version than
``unicodedata``).
"""
import functools
import gzip
import html
import os
import re
import sys
import unicodedata

import numpy as np

_DEFAULT_VOCAB_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")

# Unicode's White_Space property (PropList.txt), the set ``regex``'s \s
# matches; ``re``'s \s also takes the separators U+001C..U+001F
_WHITESPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
               "\u202f\u205f\u3000")


def _class_bodies():
    """Character-class bodies of the letters (general category L*), the
    numbers (N*) and the code points that are neither but have a case
    variant that is: ``regex`` under IGNORECASE leaves those out of
    ``[^\\s\\p{L}\\p{N}]`` but not in ``\\p{L}``, so no alternative takes
    them (U+0345, which lowers to a Greek iota). Surrogates are left
    out."""
    members = {"L": [], "N": [], "fold": []}
    for cp in range(sys.maxunicode + 1):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        cat = unicodedata.category(ch)[0]
        if cat in "LN":
            members[cat].append(cp)
        elif any(len(v) == 1 and unicodedata.category(v)[0] in "LN"
                 for v in (ch.lower(), ch.upper())):
            members["fold"].append(cp)

    def body(cps):
        starts = [i for i, cp in enumerate(cps) if i == 0
                  or cp != cps[i - 1] + 1]
        ends = starts[1:] + [len(cps)]
        return "".join(
            re.escape(chr(cps[a])) if b - a == 1 else
            f"{re.escape(chr(cps[a]))}-{re.escape(chr(cps[b - 1]))}"
            for a, b in zip(starts, ends))
    return tuple(body(members[k]) for k in ("L", "N", "fold"))


@functools.lru_cache()
def _patterns():
    """(the split pattern, the whitespace pattern), compiled once."""
    letters, numbers, fold = _class_bodies()
    # IGNORECASE for the special tokens and contractions only: on the
    # classes ``re`` would also take U+0345 as a letter
    split = re.compile(
        r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)|"
        f"[{letters}]+|[{numbers}]|"
        f"[^{_WHITESPACE}{letters}{numbers}{fold}]+")
    return split, re.compile(f"[{_WHITESPACE}]+")


@functools.lru_cache()
def _byte_encoder():
    """Reversible byte -> printable-unicode mapping (GPT-2/CLIP scheme)."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


def _clean(text: str) -> str:
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return _patterns()[1].sub(" ", text).strip().lower()


def _find_vocab(path=None):
    candidates = ([path] if path else []) + \
        ([os.environ["HOIGEN_BPE_VOCAB"]] if "HOIGEN_BPE_VOCAB" in os.environ
         else []) + [_DEFAULT_VOCAB_PATH]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError(
        "CLIP BPE merges file not found; set HOIGEN_BPE_VOCAB or place "
        "bpe_simple_vocab_16e6.txt.gz next to tokenizer.py")


class SimpleTokenizer:
    def __init__(self, bpe_path: str = None):
        self.byte_encoder = _byte_encoder()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(_find_vocab(bpe_path), "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        chars = list(self.byte_encoder.values())
        vocab = chars + [c + "</w>" for c in chars]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {"<|startoftext|>": "<|startoftext|>",
                       "<|endoftext|>": "<|endoftext|>"}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str):
        tokens = []
        for piece in _patterns()[0].findall(_clean(text)):
            piece = "".join(self.byte_encoder[b]
                            for b in piece.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(piece).split(" "))
        return tokens

    def decode(self, tokens):
        text = "".join(self.decoder[t] for t in tokens)
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer():
    return SimpleTokenizer()


def tokenize(texts, context_length: int = 77, truncate: bool = False):
    """Texts -> int32 (N, context_length) numpy array with SOT/EOT, zero
    padded (the semantics of OpenAI CLIP's ``clip.tokenize``)."""
    if isinstance(texts, str):
        texts = [texts]
    tk = _default_tokenizer()
    sot, eot = tk.encoder["<|startoftext|>"], tk.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [sot] + tk.encode(t) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {t!r} too long for context length "
                    f"{context_length}")
            ids = ids[:context_length]
            ids[-1] = eot
        out[i, :len(ids)] = ids
    return out
