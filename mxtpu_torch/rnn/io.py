"""Bucketed sequence iterators (counterpart of ``mxtpu/rnn/io.py``):
``encode_sentences`` and ``BucketSentenceIter`` on the port's ``mx.io``.
Its batches land on the current context, as ``mx.nd.array``'s do."""
from __future__ import annotations

import random as _pyrandom
from collections import defaultdict

import numpy as np

from ..base import MXNetError
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import array

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0, unknown_token=None):
    """Encode sentences to integer ids, building the vocab on the fly
    (ref: rnn/io.py:encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token:
                        word = unknown_token
                    else:
                        raise MXNetError("Unknown token %s" % word)
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed iterator for variable-length sequences feeding
    BucketingModule (ref: rnn/io.py:BucketSentenceIter)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            counts = defaultdict(int)
            for s in sentences:
                counts[len(s)] += 1
            buckets = [i for i, n in sorted(counts.items()) if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets.sort()
        self.buckets = buckets
        self.data = [[] for _ in buckets]
        self.invalid_label = invalid_label
        for sent in sentences:
            if len(sent) == 0:
                continue
            buck = next((i for i, b in enumerate(buckets)
                         if b >= len(sent)), None)
            if buck is None:
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]
        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        self.reset()

    @property
    def provide_data(self):
        shape = (self.batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else \
            (self.default_bucket_key, self.batch_size)
        return [DataDesc(self.data_name, shape, self.dtype,
                         layout=self.layout)]

    @property
    def provide_label(self):
        shape = (self.batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else \
            (self.default_bucket_key, self.batch_size)
        return [DataDesc(self.label_name, shape, self.dtype,
                         layout=self.layout)]

    def reset(self):
        self.curr_idx = 0
        self.idx = []
        for i, buck in enumerate(self.data):
            if len(buck):
                np.random.shuffle(buck)  # in place: reshuffle batch membership
            for j in range(0, len(buck) - self.batch_size + 1,
                           self.batch_size):
                self.idx.append((i, j))
        _pyrandom.shuffle(self.idx)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.data[i][j:j + self.batch_size]
        # label = data shifted left by one (next-token prediction)
        label = np.full_like(data, self.invalid_label)
        label[:, :-1] = data[:, 1:]
        if self.major_axis == 1:
            data = data.T
            label = label.T
        bucket_key = self.buckets[i]
        shape = data.shape
        return DataBatch(
            data=[array(data)], label=[array(label)],
            bucket_key=bucket_key,
            provide_data=[DataDesc(self.data_name, shape, self.dtype,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, shape, self.dtype,
                                    layout=self.layout)])
