"""``work.py``'s counts against counts made by hand at a tiny shape."""
from __future__ import annotations

import pytest
import torch

from benchmark import stories, work


def test_least_time_takes_the_larger_bound():
    assert work.least_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(1.979e15, 1.0) == pytest.approx(1.0)
    assert work.least_s(2 * 1.979e15, 3.35e12) == pytest.approx(2.0)


def test_lattice_call_by_hand():
    # 3 live rows with 5 nonzeros in all, 4 outputs, 7 inputs, 2 runs:
    # weights 2*4*7 bytes, (index, count) pairs 2*5, outputs 3*4;
    # a multiply and an add per nonzero and output
    ops, nbytes = work.lattice_call(3, 5, 4, 7, runs=2)
    assert ops == 2 * 5 * 4
    assert nbytes == 2 * 4 * 7 + 2 * 5 + 3 * 4
    # a dense input: one byte an entry
    ops, nbytes = work.lattice_call(3, 3 * 4, 4, 4, dense=True)
    assert (ops, nbytes) == (2 * 12 * 4, 16 + 12 + 12)


def test_chain_call_by_hand():
    # 2 queries, 5 live rows in all, K=3, D=4
    ops, nbytes = work.chain_call(2, 5, 3, 4)
    assert nbytes == 5 * 6 * 4 + 2 * 2 * 4 + 2 + 3 * 16
    assert ops == 3 * (4 * 5 * 4 + 2 * 2 * 16)


def test_forward_flops_by_hand():
    # one sample with 2 live rows, K=1, D=2, I=3: query embedding 12,
    # output 12, the linear map 8 and the residual 2; per row the 2
    # embeddings 2*12 and the score and the weighted sum 4+4... per hop
    got = work.forward_flops(1, 2, 1, 2, 3)
    per_sample = 12 + 12 + 8 + 2
    per_row = 2 * 12 + 8
    assert got == per_sample + 2 * per_row


def test_forward_lattice_is_ten_launches():
    one_q = work.least_s(*work.lattice_call(4, 9, 60, 29))
    one_m = work.least_s(*work.lattice_call(20, 70, 60, 29))
    one_h = work.least_s(*work.lattice_call(4, 4 * 60, 60, 60, dense=True))
    got = work.forward_lattice_least_s(4, 9, 20, 70, 3, 60, 29)
    assert got == pytest.approx(one_q + 6 * one_m + 3 * one_h)


def test_story_nonzeros_are_the_words_and_the_time_slot():
    g = stories.generator(5, 0, "cpu")
    st = stories.make_stories(6, 19, 10, 6, (1, 10), (1, 6), 3, g, "cpu")
    words = (st["word_idx"] >= 0).sum(-1)
    distinct = torch.tensor([[len(set(w for w in row if w >= 0))
                              for row in story] for story in
                             st["word_idx"].tolist()])
    live = st["mask"]
    nnz = stories.nonzeros(st["memory"])
    assert torch.equal(nnz, torch.where(live, distinct + 1, 0))
    assert torch.equal(st["memory"].sum(-1), torch.where(live, words + 1.0,
                                                         0.0))
