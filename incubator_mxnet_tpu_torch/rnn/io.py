"""Bucketed sentence iterator (twin of ``incubator_mxnet_tpu/rnn/io.py``;
ref: python/mxnet/rnn/io.py — BucketSentenceIter, encode_sentences):
groups variable-length sequences into a small set of padded bucket
lengths, so each bucket is one static shape (one executor of a
``BucketingModule``).

``reset`` shuffles with Python's ``random`` and numpy's global
generator, as the JAX iterator does, so the same seeds give the same
batches in both packages.  Batches are host (CPU) arrays; the executor
copies them onto its device."""
import random as pyrandom

import numpy as np

from ..context import cpu
from ..io.io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Token lists -> id lists, building a vocab (ref: rnn/io.py
    encode_sentences)."""
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
                assert new_vocab, f"unknown token {word}"
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pads each sentence to its bucket length; yields one bucket per
    batch (ref: rnn/io.py BucketSentenceIter)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(counts)
                       if n >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label,
                           dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]
        if ndiscard:
            print(f"WARNING: discarded {ndiscard} sentences longer "
                  f"than the largest bucket")
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        if self.major_axis == 0:
            self.provide_data = [DataDesc(
                data_name, (batch_size, self.default_bucket_key),
                layout=layout)]
            self.provide_label = [DataDesc(
                label_name, (batch_size, self.default_bucket_key),
                layout=layout)]
        else:
            self.provide_data = [DataDesc(
                data_name, (self.default_bucket_key, batch_size),
                layout=layout)]
            self.provide_label = [DataDesc(
                label_name, (self.default_bucket_key, batch_size),
                layout=layout)]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        pyrandom.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        from .. import nd
        for buck in self.data:
            if len(buck) == 0:  # an explicit bucket got no sentences
                self.nddata.append(None)
                self.ndlabel.append(None)
                continue
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, ctx=cpu(),
                                        dtype=self.dtype))
            self.ndlabel.append(nd.array(label, ctx=cpu(),
                                         dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch(
            [data], [label], pad=0,
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])

    def __next__(self):
        return self.next()
