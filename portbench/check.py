"""The comparison that decides ``correct``, made once the window has closed.

What the timed path produced is held against the plain reference:

* ``budgets_off``: requests whose stamped budget differs from the one the
  reference works out again from the mix's problem (limit 0);
* ``token_counts_off``: finished requests that did not emit exactly
  ``budget + max_extra`` tokens (limit 0);
* ``tokens_out_of_vocab``: served tokens outside the vocabulary (limit 0);
* ``finished_none``: 1 where no request finished (limit 0);
* over a sample of the finished requests drawn from the seed, the
  longest among them, the reference runs once over each prompt and its
  served tokens; at each served (greedy) token's position, the gap by
  which its reference logit lies below the reference's best gives
  ``max_logit_gap`` (the widest: one token altered), ``mean_logit_gap``
  (the mean over the positions: a precision lost all along) and
  ``off_top_share`` (the share of positions, in %, where it is not the
  best). Each that the cell's ``check`` gives a limit is compared.

With ``control`` the control (``reference/<family>.py``'s
``prec="fp8"``) stands in the program's place: at the same positions,
the token that it puts first is judged as the program's would be, so
that the run comes out as not correct. The program's own numbers are
then kept among the readings. With ``probe`` the readings also hold
the served precision's witness (``prec="served"``), and for each side
the count of positions and every gap above 0, for setting the limits.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from .reference import budgets


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


def sample(finished: list, seed: int, k: int) -> list:
    """The finished request that served the most tokens (the longest
    prompt among those) and ``k - 1`` more drawn from the seed."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.tokens), r.prompt_len,
                                           -r.rid))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 99]))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def gap_numbers(g: torch.Tensor) -> dict:
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "off_top_share": 100.0 * float((g > 0).double().mean())}


def run(spec: dict, mix: dict, cell: dict, leaves, seed: int, reqs: list,
        dev, control: bool = False, probe: bool = False) -> tuple:
    """Returns (checks, readings): the checks that decide ``correct``, and
    what the control and the probe read besides."""
    want = budgets.integer_budgets(mix)
    stamped = [r for r in reqs if r.budget >= 0]
    finished = [r for r in reqs if r.done]
    V = spec["vocab_size"]
    checks = [
        Check("budgets_off", sum(r.budget != want[r.task] for r in stamped),
              0),
        Check("token_counts_off", sum(len(r.tokens) != want[r.task]
                                      + r.max_extra for r in finished), 0),
        Check("tokens_out_of_vocab", sum(not 0 <= t < V for r in finished
                                         for t in r.tokens), 0),
        Check("finished_none", 0 if finished else 1, 0)]
    readings: dict = {}
    picked = [r for r in sample(finished, seed, cell["check"]["sample"])
              if all(0 <= t < V for t in r.tokens)]
    if not picked:
        return checks, readings
    ref = importlib.import_module(f"portbench.reference.{spec['family']}")
    seqs = [(np.concatenate([r.prompt, np.asarray(r.tokens[:-1],
                                                  np.int64)]), r.prompt_len)
            for r in picked]
    logits = torch.cat(ref.logits(spec, leaves, seed, seqs, dev))
    sides = {"program": torch.as_tensor(
        np.concatenate([r.tokens for r in picked]), device=dev)}
    for prec, side in (("fp8", "control"), ("served", "served")):
        if probe or (control and side == "control"):
            sides[side] = torch.cat(ref.logits(spec, leaves, seed, seqs, dev,
                                               prec=prec)).argmax(-1)
    gaps = {side: ref.gaps(logits, t) for side, t in sides.items()}
    del logits
    judged = gap_numbers(gaps["control" if control else "program"])
    checks += [Check(name, judged[name], float(cell["check"][name]))
               for name in judged if name in cell["check"]]
    readings["sampled_tokens"] = int(gaps["program"].numel())
    if control:
        readings["program"] = gap_numbers(gaps["program"])
    if probe:
        readings["gaps"] = {
            side: {"n": int(g.numel()), **gap_numbers(g),
                   "above_0": [round(float(x), 5) for x in
                               torch.sort(g[g > 0]).values]}
            for side, g in gaps.items()}
    return checks, readings
