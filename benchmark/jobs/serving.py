"""What the two serving jobs share: the route check and the comparison of
served answers with the reference.

An answer is one word, the argmax of the output layer's logits: it is
judged by how far its logit lies below the reference's best logit for the
same story and question (0 for the reference's own answer; a near tie
that float32 sums in another order may flip reads a gap near 0).  The
number compared, ``logit_gap``, is the widest over every answer compared.
The control serves the reference's answers computed in TF32 in the
program's place.
"""
from __future__ import annotations

import torch

from benchmark.reference import Reference


def require_chain(memn2n, prep, cfg) -> None:
    """The serving cells time the chain kernel on the exact GEMM: refuse a
    set-up that would quietly take another route."""
    if not (prep.fast and memn2n._use_chain(cfg)):
        raise RuntimeError("the cell's route is forward_prepared on the "
                           "chain kernel, and the program would not take it")


def readings(model: dict, weights, stories, answers: torch.Tensor,
             story_index=None, control=False) -> dict:
    """``logit_gap`` of ``answers`` [N, A] (A answers for each of the N
    stories, or for ``story_index`` [N]'s) against the reference's
    logits, or of the control's answers.  An answer outside the output
    layer reads an infinite gap."""
    ref = Reference(model)
    logits = ref.logits(weights, stories["memory"], stories["question"],
                        stories["mask"])
    if story_index is None:
        story_index = torch.arange(len(answers), device=logits.device)
    if control == "tf32":
        answers = Reference(model, control=True).logits(
            weights, stories["memory"], stories["question"],
            stories["mask"]).argmax(-1, keepdim=True)[story_index]
    elif control:
        raise ValueError(f"no serving control {control!r}")
    logits = logits[story_index]
    answers = answers.long().reshape(len(story_index), -1)
    bad = (answers < 0) | (answers >= logits.shape[-1])
    picked = logits.gather(-1, answers.clamp(0, logits.shape[-1] - 1))
    gap = logits.max(-1, keepdim=True).values - picked
    gap = torch.where(bad, float("inf"), gap)
    return {"logit_gap": float(gap.max())}
