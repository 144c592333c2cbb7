"""One module per entry a traffic file names (``"entry": "<name>"``),
found by that name (:func:`hqrbench.spec.entry`). A module says all that
the loop, the yardstick and the judge need of its calls:

* ``flops(m, n)``: the nominal work of one call (:mod:`hqrbench.work`);
* ``setup(loop)``: state the calls share, made before the warm-up;
* ``draw(loop, tag, index)``: a call's fresh inputs, as a tuple;
* ``call(loop, *drawn)``: the call, inside the benchmark's spans; returns
  ``(x, the factorization the call used or None)``;
* ``matrix_of(index)``: the ``(tag, index)`` of the A call ``index``
  worked on, which the judge draws again.

A new entry adds a module here; the loop, the yardstick and the judge
name none.
"""
