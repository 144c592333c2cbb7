"""The judge: the numbers that decide ``correct``, worked out by the plain
reference (:mod:`hqrbench.reference.householder`, float64) from inputs the
benchmark draws again, against the outputs the timed calls returned.

* ``factor_err``: ||Q R - A||_F / ||A||_F of a factorization the window's
  calls used (the sampled calls' own, or the set-up one that every
  ``solve`` call used), Q R formed from its stored reflectors;
* ``x_err``: ||x - x_ref|| / ||x_ref|| of a sampled call's solution against
  the reference's;
* ``fit_err``: ||A (x - x_ref)|| / (||A||_F ||x_ref||), the same error free
  of A's condition number.

Each number is the worst over the sampled calls. A cell compares the
numbers its ``limits/<cell>.json`` names, each against its own limit.
"""

from __future__ import annotations

import torch

from hqrbench.loop import Inputs, Window
from hqrbench.reference import householder as ref

F64 = torch.float64


def numbers(entry, inputs: Inputs, window: Window) -> dict:
    """The worst value of each number over the window's sampled calls,
    ``entry`` the module of the calls (:mod:`hqrbench.entries`): the A
    each call worked on (``entry.matrix_of``) and its b are drawn again,
    and each factorization is judged once."""
    out = {}

    def worst(name, value):
        # a NaN must win: max() would keep the number before it
        if name not in out or not value <= out[name]:
            out[name] = value

    key = A64 = H_ref = a_ref = None
    judged = set()
    for s in sorted(window.samples, key=lambda s: entry.matrix_of(s.index)):
        if entry.matrix_of(s.index) != key:
            A64 = H_ref = a_ref = None  # freed before the next is drawn
            key = entry.matrix_of(s.index)
            A64 = inputs.matrix(*key).to(F64)
            H_ref, a_ref = ref.qr(A64)
        if s.H is not None and id(s.H) not in judged:
            judged.add(id(s.H))
            worst("factor_err", ref.factor_error(A64, s.H, s.alpha))
        x_ref = ref.solve(H_ref, a_ref, inputs.rhs("call", s.index).to(F64))
        x_err, fit_err = ref.solution_errors(A64, s.x, x_ref)
        worst("x_err", x_err)
        worst("fit_err", fit_err)
    return out


def verdict(found: dict, limits: dict) -> "tuple[bool, dict]":
    """``(every number within its limit, {name: {"value", "limit"}})``; a
    number the cell compares but the run could not work out fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = found.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    return ok, checks
