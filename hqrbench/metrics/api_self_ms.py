"""api_self_ms: the host's time inside the program's entry-point spans
(``dhqr.qr``, ``dhqr.lstsq``, ``dhqr.solve``) less their ``dhqr.*``
children (the engine, ``dhqr.factor``; Q^H b and back-substitution), per
call: argument, policy and plan resolution, ``as_tensor``, the input's
copy and the factorization object, on the host."""

from hqrbench import program


def read(view):
    prog = program.of(view)
    if not view.calls or not prog.count(program.API_SPANS):
        return None
    return 1e3 * prog.self_seconds(program.API_SPANS) / view.calls
