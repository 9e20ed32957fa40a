"""CLIP byte-pair-encoding tokenizer (OpenAI's scheme), a copy of
``video_features_tpu/utils/clip_tokenizer.py``: a reversible byte →
unicode alphabet, greedy lowest-rank BPE merges with a ``</w>`` word-end
marker, and the ``<|startoftext|>``/``<|endoftext|>`` specials.

The merge table (``bpe_simple_vocab_16e6.txt.gz``) is data, not in the
repository: it is looked up under ``$VFT_CLIP_BPE`` only. It serves
zero-shot ``show_pred``, which degrades without it (``extract/clip.py``).
``regex`` is imported inside the function that compiles the pattern.
"""
from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
VOCAB_NAME = 'bpe_simple_vocab_16e6.txt.gz'


def find_bpe_vocab() -> Optional[str]:
    """``$VFT_CLIP_BPE`` (read per call) if it names a file, else None."""
    path = os.environ.get('VFT_CLIP_BPE', '')
    return path if path and Path(path).is_file() else None


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte → printable-unicode map (the GPT-2/CLIP alphabet):
    printable ranges map to themselves, the rest shift past U+0100."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('¡'), ord('¬') + 1))
          + list(range(ord('®'), ord('ÿ') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    try:  # ftfy fixes mojibake; optional, matches reference behavior w/o it
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return ' '.join(text.split())


class SimpleTokenizer:
    """Greedy BPE with the OpenAI CLIP merge table."""

    def __init__(self, bpe_path: Optional[str] = None) -> None:
        bpe_path = bpe_path or find_bpe_vocab()
        if bpe_path is None:
            raise FileNotFoundError(
                'CLIP BPE vocab not found; set $VFT_CLIP_BPE to '
                'bpe_simple_vocab_16e6.txt.gz')
        self.byte_encoder = bytes_to_unicode()
        merges = gzip.open(bpe_path).read().decode('utf-8').split('\n')
        # header line + the first 49152-256-2 merges, per OpenAI's slice
        merges = merges[1:49152 - 256 - 2 + 1]
        merge_pairs = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab += [v + '</w>' for v in vocab]
        vocab += [''.join(m) for m in merge_pairs]
        vocab += ['<|startoftext|>', '<|endoftext|>']
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merge_pairs)}
        self.cache = {'<|startoftext|>': '<|startoftext|>',
                      '<|endoftext|>': '<|endoftext|>'}
        self._pattern = self._compile_pattern()

    @staticmethod
    def _compile_pattern():
        try:
            import regex
            return regex.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
                r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
        except ImportError:
            import re
            # stdlib emulation of the unicode classes: letters \p{L} ==
            # [^\W\d_] (word chars minus digits minus underscore), \p{N} ≈
            # \d, and the punctuation run [^\s\p{L}\p{N}]+ == ([^\s\w]|_)+
            # (non-word-non-space, plus underscore which \w wrongly keeps).
            return re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
                r"""|[^\W\d_]+|\d|(?:[^\s\w]|_)+""", re.IGNORECASE)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = get_pairs(word)
        if not pairs:
            return token + '</w>'
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float('inf')))
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
            pairs = get_pairs(word)
        out = ' '.join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        bpe_tokens: List[int] = []
        for token in self._pattern.findall(text):
            token = ''.join(self.byte_encoder[b] for b in token.encode('utf-8'))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(' '))
        return bpe_tokens


def tokenize(texts, tokenizer: Optional[SimpleTokenizer] = None,
             context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """List of strings → (N, 77) int32 token matrix (reference clip.py:200-240
    semantics: SOT + bpe + EOT, zero-padded; over-long inputs error)."""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or SimpleTokenizer()
    sot = tokenizer.encoder['<|startoftext|>']
    eot = tokenizer.encoder['<|endoftext|>']
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            raise RuntimeError(
                f'Input {text!r} is too long for context length {context_length}')
        result[i, :len(tokens)] = tokens
    return result
