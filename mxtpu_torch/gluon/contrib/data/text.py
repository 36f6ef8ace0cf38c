"""Language-modelling text datasets of the PyTorch port (``mxtpu``'s
``gluon/contrib/data/text.py``): WikiText-2 and WikiText-103 read from
their extracted token files, never downloaded (the same IOError text as
``mxtpu`` when the file is missing). Each sample is a ``seq_len`` vector
of int32 token indices and its next-token labels; the vocabulary is
built from the file's counts with ``<eos>`` ending each line. Samples
stay on the host (``cpu()``), as the port's other datasets' do.

``Vocabulary`` is the port's own copy of ``mxtpu.contrib.text.vocab``'s
(the port imports nothing of ``mxtpu``).
"""
from __future__ import annotations

import collections
import io
import os

import numpy as np

from ...data import dataset
from .... import ndarray as nd
from ....context import cpu

__all__ = ["Vocabulary", "WikiText2", "WikiText103"]

EOS_TOKEN = "<eos>"

_SEGMENT_ALIASES = {"train": "train", "val": "valid", "validation": "valid",
                    "valid": "valid", "test": "test"}


class Vocabulary:
    """Tokens indexed by frequency (ties by token), the unknown token at
    0 and the reserved tokens after it (reference
    ``contrib/text/vocab.py``)."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        if reserved_tokens is not None and (
                unknown_token in reserved_tokens
                or len(set(reserved_tokens)) != len(reserved_tokens)):
            raise ValueError("reserved tokens must be unique and must "
                             "not contain the unknown token")
        self._unknown_token = unknown_token
        self._reserved_tokens = list(reserved_tokens) if reserved_tokens \
            else None
        self._idx_to_token = [unknown_token] + list(reserved_tokens or [])
        self._token_to_idx = {t: i for i, t in
                              enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        assert isinstance(counter, collections.Counter)
        known = set(self._idx_to_token)
        pairs = sorted(counter.items(), key=lambda t: t[0])
        pairs.sort(key=lambda t: t[1], reverse=True)
        limit = len(counter) if most_freq_count is None else most_freq_count
        indexed = 0
        for token, freq in pairs:
            if freq < min_freq or indexed >= limit:
                break
            if token in known:
                continue
            self._idx_to_token.append(token)
            self._token_to_idx[token] = len(self._idx_to_token) - 1
            indexed += 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) to index(es); an unknown token is 0."""
        if isinstance(tokens, str):
            return self._token_to_idx.get(tokens, 0)
        return [self._token_to_idx.get(t, 0) for t in tokens]

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        out = []
        for i in ([indices] if single else indices):
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError("token index %d out of range" % i)
            out.append(self._idx_to_token[i])
        return out[0] if single else out


class _WikiText(dataset.Dataset):
    _namespace = None
    _file_pattern = "wiki.%s.tokens"

    def __init__(self, root, segment, seq_len, vocab=None, filename=None):
        if segment not in _SEGMENT_ALIASES:
            raise ValueError("segment must be one of %s, got %r"
                             % (sorted(_SEGMENT_ALIASES), segment))
        segment = _SEGMENT_ALIASES[segment]
        self._root = os.path.expanduser(root)
        self._segment = segment
        self._seq_len = seq_len
        self._vocab = vocab
        self._counter = None
        path = filename or os.path.join(self._root,
                                        self._file_pattern % segment)
        if not os.path.exists(path):
            raise IOError(
                "%s not found. This environment has no network egress, so "
                "the dataset is not auto-downloaded; obtain the %s token "
                "archive and place the extracted file at %r (or pass "
                "filename=)." % (path, self._namespace, path))
        data, label = self._read(path)
        n = (len(data) // seq_len) * seq_len
        host = cpu()
        self._data = nd.array(data[:n].reshape(-1, seq_len), ctx=host,
                              dtype="int32")
        self._label = nd.array(label[:n].reshape(-1, seq_len), ctx=host,
                               dtype="int32")

    @property
    def vocabulary(self):
        return self._vocab

    @property
    def frequencies(self):
        return self._counter

    def _read(self, path):
        with io.open(path, "r", encoding="utf8") as f:
            content = f.read()
        tokens = []
        counter = collections.Counter()
        for raw_line in content.splitlines():
            line = raw_line.strip().split()
            if line:
                counter.update(line)
                tokens.extend(line)
                tokens.append(EOS_TOKEN)
        self._counter = counter
        if self._vocab is None:
            self._vocab = Vocabulary(counter=counter,
                                     reserved_tokens=[EOS_TOKEN])
        idx = np.array(self._vocab.to_indices(tokens), np.int32)
        return idx[:-1], idx[1:]

    def __getitem__(self, i):
        return self._data[i], self._label[i]

    def __len__(self):
        return self._label.shape[0]


class WikiText2(_WikiText):
    """WikiText-2 word-level LM dataset (reference text.py WikiText2)."""

    _namespace = "wikitext-2"

    def __init__(self, root="~/.mxtpu/datasets/wikitext-2", segment="train",
                 vocab=None, seq_len=35, filename=None):
        super().__init__(root, segment, seq_len, vocab, filename)


class WikiText103(_WikiText):
    """WikiText-103 word-level LM dataset (reference text.py
    WikiText103)."""

    _namespace = "wikitext-103"

    def __init__(self, root="~/.mxtpu/datasets/wikitext-103",
                 segment="train", vocab=None, seq_len=35, filename=None):
        super().__init__(root, segment, seq_len, vocab, filename)
