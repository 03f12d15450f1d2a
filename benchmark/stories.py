"""The benchmark's one traffic generator: seeded bAbI-shaped stories, made
on the device from a traffic file's parameters.

bAbI is not in the repository, so every cell runs on synthetic stories at
bAbI's shapes (the recipe of ``qmann_tpu_torch.data.synthetic_samples``,
copied here and vectorized so that the yardstick does not move with the
program).  The vocabulary has ``vocab`` columns, index 0 the NULL word; a
third of the other words are places, the rest actors.  A sentence holds
one place and actors; the question holds ``question_words`` actors; the
answer is the place of the story's most recent sentence.  The bag-of-words
rows are the vectorizer's (``data/babi.py::vectorize``): word counts plus
the temporal one-hot at column ``vocab + n_sen - j - 1`` of sentence j,
set to 1.

Every seed draws the same multiset of story lengths and sentence lengths
(an even spread over the traffic's range), in its own order, with its own
words: a seed changes which stories run, not how much work they are.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed:
    streams (data, weights, arrivals) never share draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (2 ** 63))
    return g


def even_spread(n: int, lo: int, hi: int, g: torch.Generator,
                device) -> torch.Tensor:
    """n integers spread evenly over [lo, hi], in the generator's order."""
    vals = lo + torch.div(torch.arange(n, device=device) * (hi - lo + 1), n,
                          rounding_mode="floor")
    return vals[torch.randperm(n, generator=g, device=device)]


def make_stories(n: int, vocab: int, max_sentences: int, max_words: int,
                 sentences: Sequence[int], words: Sequence[int],
                 question_words: int, g: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """n stories: float32 bag-of-words ``memory`` [n, M, V+M],
    ``question`` [n, V+M] and one-hot ``answer`` [n, V+M], the bool
    ``mask`` [n, M] of live rows, ``n_sen`` [n], and the word indices the
    rows were made of (``word_idx`` [n, M, W], -1 where a slot is empty;
    ``question_idx`` [n, Q]; ``answer_idx`` [n])."""
    V, M, W = vocab, max_sentences, max_words
    if not (1 <= sentences[0] <= sentences[1] <= M
            and 1 <= words[0] <= words[1] <= W and question_words <= W):
        raise ValueError("story lengths outside the layout")
    I = V + M
    n_places = max(1, (V - 1) // 3)
    n_actors = V - 1 - n_places
    n_sen = even_spread(n, sentences[0], sentences[1], g, device)
    n_words = even_spread(n * M, words[0], words[1], g, device).view(n, M)
    # slot 0 of every sentence is its place, the others actors
    place = 1 + torch.randint(0, n_places, (n, M), generator=g, device=device)
    actor = 1 + n_places + torch.randint(0, n_actors, (n, M, W), generator=g,
                                         device=device)
    word_idx = torch.cat([place[..., None], actor[..., 1:]], dim=-1)
    slot = torch.arange(W, device=device)
    row = torch.arange(M, device=device)
    live = row[None, :] < n_sen[:, None]                        # [n, M]
    used = (slot[None, None, :] < n_words[..., None]) & live[..., None]
    word_idx = torch.where(used, word_idx, -1)
    # counts into an extra column for the empty slots, dropped after
    memory = torch.zeros((n, M, I + 1), dtype=torch.float32, device=device)
    memory.scatter_add_(2, torch.where(used, word_idx, I),
                        torch.ones(word_idx.shape, device=device))
    memory = memory[..., :I].contiguous()
    # the temporal one-hot of each live row (a dead row's index is zeroed
    # with the row)
    te = (V + n_sen[:, None] - row[None, :] - 1).clamp_min(0)
    memory.scatter_(2, te[..., None], 1.0)
    memory = memory * live[..., None]
    question_idx = 1 + n_places + torch.randint(
        0, n_actors, (n, question_words), generator=g, device=device)
    question = torch.zeros((n, I), dtype=torch.float32, device=device)
    question.scatter_add_(1, question_idx, torch.ones(question_idx.shape,
                                                      device=device))
    answer_idx = place.gather(1, (n_sen - 1)[:, None])[:, 0]
    answer = torch.zeros((n, I), dtype=torch.float32, device=device)
    answer.scatter_(1, answer_idx[:, None], 1.0)
    return {"memory": memory, "question": question, "answer": answer,
            "mask": live, "n_sen": n_sen, "word_idx": word_idx,
            "question_idx": question_idx, "answer_idx": answer_idx}


def traffic_stories(traffic: dict, n: int, g: torch.Generator,
                    device) -> Dict[str, torch.Tensor]:
    """``make_stories`` with a traffic file's layout and lengths."""
    return make_stories(n, traffic["vocab"], traffic["max_sentences"],
                        traffic["max_words"], traffic["sentences"],
                        traffic["words"], traffic["question_words"], g,
                        device)


def poisson_offsets(n: int, rate: float, g: torch.Generator) -> list:
    """Arrival offsets (s) of n requests at ``rate`` per second: the gaps
    are the exponential distribution's n evenly spaced quantiles in the
    generator's order, so every seed offers the same load."""
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    gaps = -torch.log1p(-q) / rate
    gaps = gaps[torch.randperm(n, generator=g)]
    return torch.cumsum(gaps, 0).tolist()


def nonzeros(x: torch.Tensor) -> torch.Tensor:
    """Nonzero entries per row of the last axis: the bag-of-words rows'
    (index, count) pairs, their smallest exact form."""
    return (x != 0).sum(-1)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)

